"""Tile-column decoding: one tile column per device (PyTorch).

Counterpart of libde265_tpu/parallel/tile_shard.py. HEVC tiles split a
frame into columns: no intra or MV prediction crosses a tile boundary,
so each column reconstructs independently from the (replicated)
reference frames, but the loop filters cross tile boundaries when the
PPS allows it (reference deblock.cc:1020-1058, sao.cc:140-200). Each
tile column is a strip, padded to the widest column Ws, decoded on its
own entry of a list of torch devices (one per column). The list may
repeat a device: on one card every strip runs there, one after another,
and there is one DPB replica. The JAX package's mesh collectives become
copies between the devices of the list, in one process:

  host (numpy): pack_frame(real_slots=False), then cut its grids and
      residual buckets into halo-extended strips (split_strips);
  per distinct device: K5 builds the referenced frames' tile tables
      (they are a replicated input);
  per strip: MC (K2 in strip form) and residuals;
  halo exchange, once every strip has its pre-filter pixels: 16 luma / 8
      chroma columns of each neighbour's strip copied to this strip's
      device (the JAX all_gather + one-hot select);
  per strip: deblocking (K6) and SAO (K3) on the halo-extended strip,
      both reading the global CTB tables at the strip's xoff, then the
      crop;
  reassembly: each strip's valid columns written into the output slot
      of every DPB replica (the JAX all_gather into the replicated DPB).

A frame runs in the telemetry span "frame" (telemetry.py), and each
step in a span inside it (tables, mc, residual, halo, deblock, sao,
assemble; a strip's inputs in convert.plan_from_numpy's "upload"), whose
profiler ranges profile_frames.py reads.

Like the JAX strip program, this one writes only the DPB replicas;
device_stream.ShardedStreamDecoder refreshes the persistent MC tile
tables of the frame after it (the JAX decoder does not: ROADMAP queue 3).
"""
import contextlib

import numpy as np
import torch

from .. import telemetry

from ..convert import plan_from_numpy
from ..frame_program import _scatter_residual_slots, mc_inputs
from ..ops.kernels.deblock import deblock_frame
from ..ops.kernels.mc_filter import mc_predict
from ..ops.kernels.sao_filter import sao_ctb
from ..ops.mc_tile import build_tables
from ..ops.transform import residual_batch
from ..packing import pack_frame
from ..plan import MODE_INTRA

HALO_Y = 16            # luma halo columns (covers every edge touching us)
HALO_C = 8             # chroma halo columns
GB = 4                 # 4x4-grid halo blocks (= HALO_Y/4)

SHARDED_KEYS = ("pm", "cbf", "tucb", "edgeall", "qp", "off", "pf", "mv",
                "poc", "slot")


# ------------------------------------------------------------ host half
def strip_geometry(plan, ndev):
    """Tile-column strip geometry from the PPS colBd (CTB units,
    pps.h:109-151): per-column pixel origins x0, valid pixel widths w,
    and the padded strip width Ws (the widest column). Uniform grids are
    the case w[d] == Ws."""
    pps, sps = plan.pps, plan.sps
    ctb = 1 << sps.Log2CtbSizeY
    bd = pps.colBd                          # CTB units, len ndev+1
    assert pps.num_tile_columns == ndev
    x0 = [int(bd[d]) * ctb for d in range(ndev)]
    w = [min(int(bd[d + 1]) * ctb, plan.W) - x0[d] for d in range(ndev)]
    Ws = max(int(bd[d + 1] - bd[d]) for d in range(ndev)) * ctb
    return x0, w, Ws


def split_strips(plan, cfg, fid_slot, ndev):
    """Host: packed frame -> (strip-stacked dict, replicated dict, x0w).
    Strips are the ndev tile columns, padded to the widest column (short
    strips carry dead right padding, cropped by the reassembly). x0w:
    (ndev, 2) int32 [pixel origin, valid width] per strip."""
    t = pack_frame(plan, cfg, fid_slot, real_slots=False)
    if cfg.pu_grid8:
        # strips cut 4x4-granular grids: undo pack_frame's 8x8 upload
        # subsampling
        for k in ("mv", "poc", "pf", "slot") + \
                (("ref_idx",) if cfg.has_weights else ()):
            t[k] = np.repeat(np.repeat(t[k], 2, axis=0), 2, axis=1)
    for cidx, log2, K in cfg.buckets:
        t.pop(f"re_i_{cidx}_{log2}", None)
        t.pop(f"re_v_{cidx}_{log2}", None)
    x0s, ws, Ws = strip_geometry(plan, ndev)
    ws4 = Ws // 4
    tsh = {}
    # halo-extended 4x4 grids (the right pad covers the widest strip)
    for k in SHARDED_KEYS + (("ref_idx",) if cfg.has_weights else ()):
        g = t.pop(k)
        pad = [(0, 0)] * g.ndim
        pad[1] = (GB, GB + ws4)
        gp = np.pad(g, pad)
        tsh[k] = np.stack([gp[:, x0s[d] // 4:x0s[d] // 4 + ws4 + 2 * GB]
                           for d in range(ndev)])
    # residual buckets in strip coordinates
    tu_meta, coeff_pool, _ = plan._tu_arrays
    sel = (tu_meta[:, 9] >= 0) & (tu_meta[:, 8] != MODE_INTRA) \
        if tu_meta.shape[0] else np.zeros(0, bool)
    for cidx, log2, K in cfg.buckets:
        n = 1 << log2
        sub = 1 if cidx == 0 else 2
        Wsc = Ws // sub
        # CEIL lattice (as frame_program._scatter_residual_slots)
        ncols = -(-Wsc // n)
        nslots = (-(-(cfg.H // sub) // n)) * ncols
        cs, qs, ss = [], [], []
        for d in range(ndev):
            x0c = x0s[d] // sub
            wc = ws[d] // sub
            if tu_meta.shape[0]:
                m = sel & (tu_meta[:, 0] == cidx) & (tu_meta[:, 3] == log2) \
                    & (tu_meta[:, 1] >= x0c) & (tu_meta[:, 1] < x0c + wc)
                rows = tu_meta[m]
            else:
                rows = np.zeros((0, 10), np.int32)
            k = rows.shape[0]
            assert k <= K
            coeffs = np.zeros((K, n, n), np.int16)
            if k:
                gi = rows[:, 9][:, None] + np.arange(n * n)[None, :]
                coeffs[:k] = coeff_pool[gi].reshape(k, n, n)
            qp = np.zeros(K, np.int32)
            qp[:k] = rows[:, 5]
            slots = np.full(K, nslots, np.int32)
            if k:
                slots[:k] = (rows[:, 2] >> log2) * ncols + \
                    ((rows[:, 1] - x0c) >> log2)
            cs.append(coeffs)
            qs.append(qp)
            ss.append(slots)
        for pre in ("rc", "rq", "rs"):
            t.pop(f"{pre}_{cidx}_{log2}", None)
        tsh[f"rc_{cidx}_{log2}"] = np.stack(cs)
        tsh[f"rq_{cidx}_{log2}"] = np.stack(qs)
        tsh[f"rs_{cidx}_{log2}"] = np.stack(ss)
    x0w = np.stack([np.asarray(x0s, np.int32),
                    np.asarray(ws, np.int32)], axis=1)
    return tsh, t, x0w


# ---------------------------------------------------------- device half
def _on(dev):
    """Make `dev` the current CUDA device (the kernels launch on the
    current device's streams); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _expand_ctb4_strip(a, cfg, ws4h, x0):
    """Global CTB grid -> strip-local halo-extended 4x4 grid (gh, ws4h)."""
    nctby, nctbx = a.shape
    sh = cfg.log2ctb - 2
    ys = torch.arange(cfg.H // 4, device=a.device) >> sh
    xs = torch.clamp((torch.arange(ws4h, device=a.device) - GB + x0 // 4)
                     >> sh, 0, nctbx - 1)
    return a[ys][:, xs]


def _halo_concat(locs, halo, wds):
    """Attach left/right halo columns from the neighbouring strips.
    locs[d]: (H, Ws) strip d on its device, valid columns [0, wds[d]).
    The left halo is the previous strip's last `halo` valid columns; the
    next strip's first `halo` columns land at lane halo + wds[d], so the
    filters read true cross-tile pixels even in a short strip. The
    picture's outer edges get zeros. Returns (H, Ws + 2*halo) strips."""
    out = []
    for d, loc in enumerate(locs):
        z = loc.new_zeros((loc.shape[0], halo))
        left = locs[d - 1][:, wds[d - 1] - halo:wds[d - 1]].to(loc.device) \
            if d else z
        right = locs[d + 1][:, :halo].to(loc.device) \
            if d + 1 < len(locs) else z
        ext = torch.cat([left, loc, z], dim=1)
        ext[:, halo + wds[d]:2 * halo + wds[d]] = right
        out.append(ext)
    return out


def strip_mc_inputs(t, cfg, x0, Ws):
    """K2's per-block inputs (frame_program.mc_inputs) for the centre
    (H/4, Ws/4) of one strip's halo-extended grids."""
    ws4 = Ws // 4
    c = slice(GB, GB + ws4)
    keys = ("pm", "pf", "mv", "slot") + \
        (("ref_idx",) if cfg.has_weights else ())
    g = {k: t[k][:, c] for k in keys}
    s4 = None
    if cfg.has_weights:
        g.update((k, t[k]) for k in ("wt", "wt_denom", "has_pw"))
        s4 = _expand_ctb4_strip(t["sidx"], cfg, ws4 + 2 * GB, x0)[:, c]
    return mc_inputs(g, cfg, s4)


def _strip_recon(t, tables, x0, cfg, Ws):
    """Pre-filter pixels of one strip: MC (K2 in strip form) from the
    per-frame tables, then the inter residuals. Returns int32 (Y, Cb, Cr)
    of (H, Ws) / (H/2, Ws/2)."""
    bd = cfg.bitdepth
    with telemetry.span("mc"):
        args = ((cfg.H, cfg.W), *strip_mc_inputs(t, cfg, x0, Ws), bd,
                cfg.has_bi)
        Y, = mc_predict(tables[0], *args, strip=Ws, x0=x0)
        Cb, Cr = mc_predict(tables[1], *args, strip=Ws, x0=x0)
    with telemetry.span("residual"):
        planes = [Y, Cb, Cr]
        for cidx, log2, K in cfg.buckets:
            res = residual_batch(t[f"rc_{cidx}_{log2}"].to(torch.int32),
                                 t[f"rq_{cidx}_{log2}"], log2, False, bd)
            planes[cidx] = _scatter_residual_slots(
                planes[cidx], res, t[f"rs_{cidx}_{log2}"], log2,
                (1 << bd) - 1)
        return [p.contiguous() for p in planes]


def _strip_filter(t, Ye, Cbe, Cre, x0, cfg, Ws):
    """Deblocking and SAO (K3) on one halo-extended strip, then the crop
    to its (H, Ws) / (H/2, Ws/2) columns."""
    bd = cfg.bitdepth
    xoff = x0 - HALO_Y
    with telemetry.span("deblock") as sp:
        n = deblock_frame.launches
        Ye, Cbe, Cre = deblock_frame(Ye, Cbe, Cre, t, cfg.fcfg, bd, xoff)
        sp.n = deblock_frame.launches - n
    if cfg.sao_enabled:
        with telemetry.span("sao"):
            Ye, Cbe, Cre = (sao_ctb(P, t, cfg.scfg, ci, xoff, bitdepth=bd)
                            for ci, P in enumerate((Ye, Cbe, Cre)))
    return (Ye[:, HALO_Y:HALO_Y + Ws], Cbe[:, HALO_C:HALO_C + Ws // 2],
            Cre[:, HALO_C:HALO_C + Ws // 2])


def decode_frame_tiles(dpbs, devices, tsh, trep, x0w, out_slot, cfg):
    """Decode one pure-inter frame as len(devices) strips.
    dpbs: {device: [dy, dcb, dcr]} DPB replicas ((REF_SLOTS,H,W) /
    (REF_SLOTS,H/2,W/2) int16), one per distinct entry of `devices`,
    updated in place at `out_slot`. tsh / trep / x0w: split_strips'
    output (numpy); strip d runs on devices[d]. The strip width Ws is
    the one split_strips cut the grids at (strip_geometry's widest
    column in whole CTBs)."""
    with telemetry.span("frame"):
        return _decode_strips(dpbs, devices, tsh, trep, x0w, out_slot, cfg)


def _decode_strips(dpbs, devices, tsh, trep, x0w, out_slot, cfg):
    assert len(devices) == x0w.shape[0]
    Ws = (tsh["pm"].shape[2] - 2 * GB) * 4
    wds = [int(w) for w in x0w[:, 1]]
    # replicated inputs and the K5 tables, once per distinct device
    reps, tables = {}, {}
    for dev in dict.fromkeys(devices):
        with _on(dev), telemetry.span("tables"):
            reps[dev] = plan_from_numpy(trep, dev)
            sel = reps[dev]["sel_slots"].to(torch.int64)
            dy, dcb, dcr = dpbs[dev]
            tables[dev] = build_tables(dy[sel], dcb[sel], dcr[sel],
                                       cfg.bitdepth)
    # every strip's pre-filter pixels before any halo is taken
    ts, pre = [], []
    for d, dev in enumerate(devices):
        with _on(dev):
            t = plan_from_numpy({k: v[d] for k, v in tsh.items()}, dev)
            t.update(reps[dev])
            ts.append(t)
            pre.append(_strip_recon(t, tables[dev], int(x0w[d, 0]), cfg,
                                    Ws))
    with telemetry.span("halo"):
        ext = [_halo_concat([p[i] for p in pre], h, [w // s for w in wds])
               for i, (h, s) in enumerate(((HALO_Y, 1), (HALO_C, 2),
                                           (HALO_C, 2)))]
    outs = []
    for d, dev in enumerate(devices):
        with _on(dev):
            outs.append(_strip_filter(ts[d], ext[0][d], ext[1][d],
                                      ext[2][d], int(x0w[d, 0]), cfg, Ws))
    # width-aware reassembly into the out slot of every replica
    for dev, planes in dpbs.items():
        with _on(dev), telemetry.span("assemble"):
            for (x0, w), strip in zip(x0w.tolist(), outs):
                for ci, (dst, src) in enumerate(zip(planes, strip)):
                    s = 1 if ci == 0 else 2
                    dst[out_slot, :, x0 // s:(x0 + w) // s] = \
                        src[:, :w // s].to(dev, torch.int16)
    return dpbs
