"""The fused frame program, device half, in PyTorch.

Counterpart of the device side of libde265_tpu/frame_program.py
(`decode_frame_device`, `_finish_frame`, the tile-table helpers and the
blob unpack): one inter or intra frame is decoded on the device from its
packed plan tensors — tile-table MC -> residual batches -> intra band
scan -> deblocking -> SAO -> DPB and tile-table insert. The residual
stage carries transform-skip, transquant bypass and scaling lists, and
PCM blocks are pasted before the intra scan. The DPB stacks and tables
are updated in place (the JAX program donates them, so in-place update
is the same dataflow). A frame runs in the telemetry
span "frame" (telemetry.py), and each stage in a span inside it named
after the stage (grids, mc, residual, pcm, intra, deblock, sao,
insert); profile_frames.py reads their profiler ranges. `stages` leaves
stages out by not launching them (the JAX program's profiling ablation,
tools/profile_frame_stages.py); every decoder runs the full default.

The port runs every chroma format (monochrome, 4:2:0, 4:2:2, 4:4:4) at
8 to 12 bits (uint8 tile tables at 8 bits, int16 above, as the JAX
program's table_geom) with the kernels of the JAX use_pallas=True /
pallas_taps=True branches: MC (K2, uni, bi and explicit weighted
prediction) on every frame with prediction units, the tile-table update
(K1), deblocking (K6, no JAX kernel: the JAX program's XLA ops) and SAO
(K3) on every frame, the intra scan (K4) on intra TUs. At
4:2:0 K1 and K2 cover luma and the [Cb|Cr] pair; in the other formats
the tile table is luma's alone, 4:2:2 / 4:4:4 chroma prediction reads
the chroma DPB stacks (ops/mc_chroma.py, plain torch as in the JAX
program) and monochrome carries (1, 128) chroma dummies that no stage
touches. `check_slice` raises NotImplementedError for what the port does
not carry yet.
"""
import numpy as np
import torch

from . import telemetry
from .intra_fused import intra_stage_scan, unnibble, unpack_bits
from .ops.kernels.deblock import deblock_frame
from .ops.kernels.mc_filter import mc_predict
from .ops.kernels.mc_tables import update_tile_table
from .ops.kernels.sao_filter import sao_ctb
from .ops.mc_chroma import mc_chroma_dense
from .ops.mc_tile import pad_plane
from .ops.transform import residual_batch, residual_batch_sl, residual_kinds
from .packing import (BIT_KEYS, BIT2_KEYS, PAD_C, PAD_Y, REF_SLOTS,
                      ProgramCfg, table_geom)


def check_slice(cfg: ProgramCfg):
    """Raise NotImplementedError naming the first feature of the stream
    that the port does not carry yet (ROADMAP queue 1)."""
    missing = []
    if cfg.chroma_fmt not in (0, 1, 2, 3):
        missing.append(f"chroma format {cfg.chroma_fmt}")
    if not 8 <= cfg.bitdepth <= 12:
        missing.append(f"bit depth {cfg.bitdepth} (8 to 12 are ported)")
    if cfg.intra and not cfg.intra_scan:
        missing.append("intra outside the band-scan kernel")
    if missing:
        raise NotImplementedError("libde265_tpu_torch does not port: "
                                  + "; ".join(missing))


def _expand_ctb4(a, cfg):
    """CTB grid -> 4x4-block grid: block repeat + crop."""
    gh, gw = cfg.H // 4, cfg.W // 4
    f = 1 << (cfg.log2ctb - 2)
    h, w = a.shape
    return a[:, None, :, None].expand(h, f, w, f) \
        .reshape(h * f, w * f)[:gh, :gw]


def _expand_mask2(m, ry, rx):
    """4x4-block grid -> (ry, rx) samples a block: the chroma plane's
    mask of the blocks' samples."""
    return m[:, None, :, None].expand(m.shape[0], ry, m.shape[1], rx) \
        .reshape(m.shape[0] * ry, m.shape[1] * rx)


def _expand_grid2(a, gh, gw):
    """8x8-granular grid -> 4x4 grid: 2x repeat on both leading axes."""
    a = torch.repeat_interleave(a, 2, dim=0)
    return torch.repeat_interleave(a, 2, dim=1)[:gh, :gw]


def _scatter_residual_slots(plane, res, slots, log2, maxv):
    """Residual add via row scatter. The slot lattice is CEIL-sized (as
    pack_frame lays it out); padded entries carry the dump slot
    `nslots`, one row past the lattice."""
    H, W = plane.shape
    n = 1 << log2
    nrows, ncols = -(-H // n), -(-W // n)
    nslots = nrows * ncols
    table = plane.new_zeros((nslots + 1, n * n))
    table[slots.to(torch.int64)] = res.reshape(res.shape[0], n * n) \
        .to(plane.dtype)
    rp = table[:nslots].reshape(nrows, ncols, n, n).permute(0, 2, 1, 3) \
        .reshape(nrows * n, ncols * n)[:H, :W]
    return torch.clamp(plane + rp, 0, maxv)


def init_tables(cfg: ProgramCfg, device):
    """Zero-initialised persistent tile-table stacks."""
    (ry, wy), (rc, wc), dt = table_geom(cfg)
    tdt = getattr(torch, np.dtype(dt).name)
    return (torch.zeros((REF_SLOTS * ry, wy), dtype=tdt, device=device),
            torch.zeros((REF_SLOTS * rc, wc), dtype=tdt, device=device))


def update_tables(ty, tc, Y, Cb, Cr, slot, cfg: ProgramCfg):
    """Insert one frame's tile rows into the persistent tables at `slot`
    (K1, once per decoded frame; luma, then at 4:2:0 the interleaved
    [Cb|Cr]; the other formats keep a luma table only, and Cb/Cr may
    then be None)."""
    py = pad_plane(Y.to(torch.int16), PAD_Y)[None].contiguous()
    update_tile_table(ty, py, slot, 16)
    if cfg.chroma_fmt == 1:
        pc = torch.stack([pad_plane(Cb.to(torch.int16), PAD_C),
                          pad_plane(Cr.to(torch.int16), PAD_C)])
        update_tile_table(tc, pc, slot, 8)
    return ty, tc


def unpack_blob(bufs, meta):
    """Per-dtype flat buffers (packing.pack_blob, moved to the device) ->
    dict of tensor views with the stacked shapes of packing.blob_meta."""
    out = {}
    for k, dt, shape, off in meta:
        n = int(np.prod(shape)) if shape else 1
        raw = bufs[dt][off:off + n]
        if np.dtype(dt).kind == "b":
            raw = raw != 0
        out[k] = raw.reshape(shape)
    return out


def frame_grids(t, cfg: ProgramCfg):
    """Copy of a packed plan dict with the per-frame grids in the form the
    MC and the filter planners read: bit-packed 4x4 grids (and an 8x8 qp
    grid) expanded to int32 (gh, gw) grids, and the motion grids widened
    to two lanes at 4x4 granularity (all-zero for zero-PU frames)."""
    H, W = cfg.H, cfg.W
    gh, gw = H // 4, W // 4
    t = dict(t)
    if cfg.pack_bits:
        for k in BIT_KEYS:
            t[k] = unpack_bits(t[k], gw)
        for k in BIT2_KEYS:
            a = t[k]
            t[k] = unpack_bits(a[0], gw) | (unpack_bits(a[1], gw) << 1)
        if cfg.qp_grid8:
            t["qp"] = _expand_grid2(t["qp"], gh, gw)
    if cfg.skip_mc:
        # zero-PU frame: the deblock planner reads all-zero motion grids
        z = dict(dtype=torch.int32, device=t["pm"].device)
        t["mv"] = torch.zeros((gh, gw, 2, 2), **z)
        t["poc"] = torch.zeros((gh, gw, 2), **z)
        t["pf"] = torch.zeros((gh, gw, 2), **z)
        return t
    if cfg.lane0:
        # re-widen the host-collapsed single-list grids: duplicate lane 1
        # with pf1 = 0 (never consulted)
        t["mv"] = torch.stack([t["mv"], t["mv"]], dim=2)
        for k in ("poc", "slot"):
            t[k] = torch.stack([t[k], t[k]], dim=-1)
        t["pf"] = torch.stack([t["pf"], torch.zeros_like(t["pf"])], dim=-1)
    if cfg.pu_grid8:
        for k in (("mv", "poc", "pf", "slot", "ref_idx")
                  if cfg.has_weights else ("mv", "poc", "pf", "slot")):
            t[k] = _expand_grid2(t[k], gh, gw)
    return t


# the stages of the frame program (the JAX program's default `stages`);
# "tables" is K1's insert-time table update. "mc_luma_only" may be added
# beside "mc": the [Cb|Cr] K2 launch is left out at 4:2:0.
STAGES = ("mc", "res", "intra", "dbk", "sao", "tables")


def decode_frame_device(dy, dcb, dcr, ty, tc, t, out_slot,
                        cfg: ProgramCfg, stages=STAGES):
    """Decode one frame from its packed plan tensors `t` (pack_frame,
    moved to the device) into DPB slot `out_slot` (python int).
    dy/dcb/dcr: (REF_SLOTS,H,W)/(REF_SLOTS,Hc,Wc) int16 DPB stacks;
    ty/tc: persistent tile tables. All five are updated in place.
    stages: the stages that run (STAGES); a stage left out is not
    launched and its output is what the JAX program's ablation gives
    (zero prediction without "mc", no residual or PCM without "res", no
    table update without "tables"; the DPB insert always runs)."""
    with telemetry.span("frame"):
        return _decode_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg, stages)


def _decode_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg, stages):
    H, W = cfg.H, cfg.W
    Hc, Wc = cfg.chroma_dims
    with telemetry.span("grids"):
        t = frame_grids(t, cfg)
    if cfg.skip_mc or "mc" not in stages:
        z = [torch.zeros(s, dtype=torch.int32, device=dy.device)
             for s in ((H, W), (Hc, Wc), (Hc, Wc))]
        return _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg,
                             stages, *z)

    with telemetry.span("mc"):
        Y, Cb, Cr = _motion_compensate(ty, tc, dcb, dcr, t, cfg,
                                       "mc_luma_only" in stages)
    return _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg, stages,
                         Y, Cb, Cr)


def _motion_compensate(ty, tc, dcb, dcr, t, cfg, luma_only=False):
    """Inter prediction of every inter 4x4 block; zero elsewhere. K2 from
    the tile tables: one launch for luma and, at 4:2:0, one for the
    [Cb|Cr] pair (none with luma_only: zero chroma). 4:2:2 / 4:4:4
    chroma comes from the chroma DPB stacks (mc_chroma_dense);
    monochrome chroma stays the zero dummies. Returns int32 (Y, Cb,
    Cr)."""
    mv, slot, pf, wts, ex, inter = mc_inputs(t, cfg)
    args = ((cfg.H, cfg.W), mv, slot, pf, wts, ex, inter, cfg.bitdepth,
            cfg.has_bi)
    Y, = mc_predict(ty, *args)
    if cfg.chroma_fmt == 1 and not luma_only:
        Cb, Cr = mc_predict(tc, *args)
    elif cfg.mono or cfg.chroma_fmt == 1:
        Cb, Cr = (torch.zeros(cfg.chroma_dims, dtype=torch.int32,
                              device=Y.device) for _ in range(2))
    else:
        cb, cr = mc_chroma_dense(dcb, dcr, mv, slot, pf, wts, ex, cfg.H,
                                 cfg.W, cfg.bitdepth, bi=cfg.has_bi)
        m = _expand_mask2(inter, 4 // cfg.subh, 4 // cfg.subw)
        Cb, Cr = torch.where(m, cb, 0), torch.where(m, cr, 0)
    return Y, Cb, Cr


def mc_inputs(t, cfg, s4=None):
    """K2's per-block inputs from a frame's grids (frame_grids) or one
    strip's (parallel/tile_shard.py): mv (N,2,2), slot (N,2), pf (N,2)
    int32, wts (N,3,5) / ex (N,) int32 or None, and the (gh, gw) bool
    inter mask. s4: the slice-table row of every 4x4 block (default: the
    whole frame's, from t["sidx"])."""
    gh, gw = t["pf"].shape[:2]
    N = gh * gw
    i32 = torch.int32
    # the slot is resolved on the host; a block that uses list 1 only has
    # it swapped into lane 0
    slot_g = t["slot"].to(i32)                               # (gh,gw,2)
    pfg = t["pf"].to(i32)
    mvg = t["mv"].to(i32)
    swap = pfg[:, :, 0] == 0
    mv0 = torch.where(swap[..., None], mvg[:, :, 1, :], mvg[:, :, 0, :])
    s0 = torch.where(swap, slot_g[:, :, 1], slot_g[:, :, 0])
    pf = torch.stack([pfg[:, :, 0] | pfg[:, :, 1],
                      pfg[:, :, 0] & pfg[:, :, 1]], dim=-1).reshape(N, 2)
    mv = torch.stack([mv0, mvg[:, :, 1, :]], dim=2).reshape(N, 2, 2)
    slot = torch.stack([s0, slot_g[:, :, 1]], dim=-1).reshape(N, 2)
    wts, ex = _weights(t, cfg, swap, s4) if cfg.has_weights \
        else (None, None)
    inter = (t["pm"] == 0).contiguous()         # not intra (skip == inter)
    return mv, slot, pf, wts, ex, inter


def _weights(t, cfg, swap, s4=None):
    """Explicit weighted-prediction inputs of every 4x4 block: wts
    (N,3,5) int32 (w0, o0, w1, o1, log2Wd per plane, lane 0 swapped like
    the MVs) and ex (N,) int32, the slice has pred_weight_table."""
    gh, gw = swap.shape
    i64 = torch.int64
    if s4 is None:
        s4 = _expand_ctb4(t["sidx"], cfg)                    # (gh,gw)
    s4 = s4.to(i64)
    ridx = t["ref_idx"].to(i64)                              # (gh,gw,2)
    lst = torch.arange(2, device=ridx.device)[None, None, :]
    w_g = t["wt"].to(torch.int32)[s4[:, :, None], lst, ridx]  # (gh,gw,2,3,2)
    w0 = torch.where(swap[..., None, None], w_g[:, :, 1], w_g[:, :, 0])
    den = t["wt_denom"].to(torch.int32)[s4]                  # (gh,gw,3)
    wts = torch.cat([w0, w_g[:, :, 1], den[..., None]], dim=-1)
    ex = t["has_pw"][s4] != 0
    return (wts.reshape(gh * gw, 3, 5).contiguous(),
            ex.reshape(gh * gw).to(torch.int32))


def _bucket_coeffs(t, cfg, bi_, cidx, log2, K):
    """Unpacked (K, n, n) int32 levels of one inter residual bucket."""
    n = 1 << log2
    E = cfg.escapes[bi_] if cfg.escapes else 0
    Ssb = cfg.sb_caps[bi_] if cfg.sb_caps else 0
    sfx = f"_{cidx}_{log2}"
    if Ssb:
        # coded sub-blocks: one row scatter into the dense (K*nsb, 16)
        # layout, then (K, sy, sx, r, c) -> (K, n, n). Padding rows carry
        # out-of-range indices (dropped by the JAX scatter): redirect them
        # all to one dump row past the end.
        nsb = (n // 4) ** 2
        rbv = unnibble(t["rb" + sfx]).reshape(-1, 16)
        rbi = t["rbi" + sfx].to(torch.int64)
        rbi = torch.where(rbi < K * nsb, rbi, K * nsb)
        flatsb = rbv.new_zeros((K * nsb + 1, 16))
        flatsb[rbi] = rbv
        c = flatsb[:K * nsb].reshape(K, n // 4, n // 4, 4, 4) \
            .permute(0, 1, 3, 2, 4).reshape(K, n, n)
    else:
        c = unnibble(t["rc" + sfx]).reshape(K, n, n)
    if E:      # re-apply the escape values over the nibble body
        flat = torch.cat([c.reshape(-1), c.new_zeros(1)])
        flat[t["re_i" + sfx].to(torch.int64)] = t["re_v" + sfx].to(torch.int32)
        c = flat[:K * n * n].reshape(K, n, n)
    return c


def _paste_pcm(Y, Cb, Cr, t, cfg, maxv):
    """Scatter the PCM blocks' raw samples: per coded log2, the (Kp, n*n)
    luma rows `py_*` at slots `ps_*` and the (Kp, 2*csz) [Cb|Cr] rows
    `pc_*` at slots `psc_*`, as squares of the chroma block: one
    (n/2)^2 at 4:2:0, one n^2 at 4:4:4, two stacked (n/2)^2 at 4:2:2
    (psc then holds two slot rows a block); monochrome pastes luma
    only."""
    cat = cfg.chroma_fmt
    for (log2, Kp) in cfg.pcm:
        n = 1 << log2
        Y = _scatter_residual_slots(
            Y, t[f"py_{log2}"].to(torch.int32).reshape(Kp, n, n),
            t[f"ps_{log2}"], log2, maxv)
        if not cat:
            continue
        pc = t[f"pc_{log2}"].to(torch.int32)
        csz = pc.shape[1] // 2
        lg = log2 if cat == 3 else log2 - 1
        s = 1 << lg
        nsq = Kp * 2 if cat == 2 else Kp
        Cb = _scatter_residual_slots(Cb, pc[:, :csz].reshape(nsq, s, s),
                                     t[f"psc_{log2}"], lg, maxv)
        Cr = _scatter_residual_slots(Cr, pc[:, csz:].reshape(nsq, s, s),
                                     t[f"psc_{log2}"], lg, maxv)
    return Y, Cb, Cr


def _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg, stages, Y, Cb,
                  Cr):
    """Residual add + intra + loop filters + DPB/table insert, each stage
    only if it is in `stages` (the insert always)."""
    bd = cfg.bitdepth
    maxv = (1 << bd) - 1

    # ---- inter residuals
    if "res" in stages:
        with telemetry.span("residual"):
            planes = [Y, Cb, Cr]
            for bi_, (cidx, log2, K) in enumerate(cfg.buckets):
                c = _bucket_coeffs(t, cfg, bi_, cidx, log2, K)
                qpv = t[f"rq_{cidx}_{log2}"]
                smat = t[f"sm_{cidx}_{log2}"] if cfg.scaling else None
                if smat is None:
                    res = residual_batch(c, qpv, log2, False, bd)
                else:
                    res = residual_batch_sl(c, qpv, smat, log2, False, bd)
                kinds = cfg.res_kinds[bi_] if cfg.res_kinds else 0
                if kinds:
                    res = residual_kinds(res, c, qpv, smat,
                                         t[f"rk_{cidx}_{log2}"], kinds,
                                         log2, bd)
                planes[cidx] = _scatter_residual_slots(
                    planes[cidx], res, t[f"rs_{cidx}_{log2}"], log2, maxv)
            Y, Cb, Cr = planes

    # ---- PCM paste, before intra (PCM samples are neighbours of intra
    # TUs). The pm grid masked MC out of PCM blocks and no TU scatters
    # there, so the add lands on zeros: an overwrite.
    if cfg.pcm and "res" in stages:
        with telemetry.span("pcm"):
            Y, Cb, Cr = _paste_pcm(Y, Cb, Cr, t, cfg, maxv)
    Y, Cb, Cr = (p.contiguous() for p in (Y, Cb, Cr))

    # ---- intra (reads post-inter-residual neighbours, the reference's
    # in-loop order: decode_TU slice.cc:3424)
    if cfg.intra and "intra" in stages:
        with telemetry.span("intra"):
            Y, Cb, Cr = intra_stage_scan(Y, Cb, Cr, t, cfg)

    # ---- deblock (K6: two launches, in place; the span's n counts them)
    if "dbk" in stages:
        with telemetry.span("deblock") as sp:
            n = deblock_frame.launches
            Y, Cb, Cr = deblock_frame(Y, Cb, Cr, t, cfg.fcfg, bd)
            sp.n = deblock_frame.launches - n

    # ---- SAO (K3 from the per-CTB parameters, one launch per plane;
    # monochrome chroma dummies pass through)
    if cfg.sao_enabled and "sao" in stages:
        with telemetry.span("sao"):
            Y, Cb, Cr = (P if ci and cfg.mono
                         else sao_ctb(P, t, cfg.scfg, ci, bitdepth=bd)
                         for ci, P in enumerate((Y, Cb, Cr)))

    # ---- DPB + tile-table insert (K1)
    with telemetry.span("insert"):
        # one converting copy a plane (an int16 temporary would cost a
        # device-to-device memcpy more)
        dy[out_slot].copy_(Y)
        dcb[out_slot].copy_(Cb)
        dcr[out_slot].copy_(Cr)
        if "tables" in stages:
            update_tables(ty, tc, Y, Cb, Cr, out_slot, cfg)
    return dy, dcb, dcr, ty, tc
