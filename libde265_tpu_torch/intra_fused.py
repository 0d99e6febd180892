"""Fused-path intra reconstruction: the host half (packing) and the
device half, as in libde265_tpu/intra_fused.py.

Host half, a numpy copy of libde265_tpu/intra_fused.py:23-452 (the port
imports nothing of the JAX package; its wavefront level DP is
intra_wavefront.assign_levels): the availability grids, the border
availability (`border_ok`), the class statistics for stream_cfg
(`intra_frame_stats`) and the per-class packing with the band-scan slot
permutations (`pack_intra`, `pack_scan_perms`).

Device half: the per-class residual transforms (`_residuals`) and the
input assembly of the serial band-scan kernel (`intra_stage_scan`).
"""
import numpy as np
import torch

from .convert import device_table
from .intra_wavefront import assign_levels
from .ops.kernels.intra_scan import intra_scan, pack_rec, pack_span
from .ops.transform import residual_batch, residual_batch_sl, residual_kinds
from .plan import MODE_INTRA

# class id: (pl, log2) with pl 0 = luma, 1 = chroma (Cb and Cr rows share
# a class — identical geometry/levels, plane chosen per row)
INTRA_LOG2S = (2, 3, 4, 5)


def _okbytes(log2):
    return (4 * (1 << log2) + 1 + 7) // 8


# --------------------------------------------------------------- host side
def _spread_bits(v):
    out = 0
    b = 0
    while v:
        out |= (v & 1) << (2 * b)
        v >>= 1
        b += 1
    return out


def _avail_grids(plan):
    """(zg, sa4, tid4) at 4x4-luma-block granularity. zg is the global
    decode order (tile-scan CTB order × z-order within the CTB), so
    `zg[nb] < zg[cur]` == the reference's ts/z-scan availability check
    (image.cc available_zscan)."""
    g = getattr(plan, "_avail_grids", None)
    if g is not None:
        return g
    sps, pps = plan.sps, plan.pps
    gh, gw = plan.gh, plan.gw
    s = sps.Log2CtbSizeY - 2
    by4, bx4 = np.mgrid[0:gh, 0:gw].astype(np.int32)
    cy, cx = by4 >> s, bx4 >> s
    rs = cy * sps.PicWidthInCtbsY + cx
    ts = np.asarray(pps.CtbAddrRStoTS, np.int32)[rs]
    spread = np.asarray([_spread_bits(v) for v in range(1 << s)], np.int32)
    m = (1 << s) - 1
    zin = spread[bx4 & m] | (spread[by4 & m] << 1)
    zg = (ts << (2 * s)) | zin
    sa4 = np.asarray(plan.slice_addr_rs, np.int32)[cy, cx]
    tid4 = np.asarray(pps.TileId, np.int32)[rs]
    plan._avail_grids = (zg, sa4, tid4)
    return plan._avail_grids


def border_ok(plan, xs, ys, cidx_arr, log2):
    """Vectorized availability for a class batch: (N, 4n+1) bool mask of
    border-sample availability incl. constrained-intra-pred (spec 6.4.1 +
    8.4.4.2.2; reference intra_border_computer intrapred.cc:437-530).

    Availability is constant within each aligned run of border samples
    that shares one 4x4-luma-grid cell (4 luma / 2 chroma-in-4:2:0
    samples), so the decision is computed once per run and expanded —
    4x (2x) fewer gathers than per-sample. Results are memoized on the
    plan: stream_cfg's hole probe and pack_intra ask for the same
    classes (the pack wall on 4K I-frames was this function)."""
    cache = getattr(plan, "_border_ok_cache", None)
    if cache is None:
        cache = plan._border_ok_cache = {}
    key = (int(log2), xs.tobytes(), ys.tobytes(), cidx_arr.tobytes())
    hit = cache.get(key)
    if hit is not None:
        return hit
    N = xs.shape[0]
    is_luma = N > 0 and not (cidx_arr != 0).any()
    is_chroma = N > 0 and not (cidx_arr == 0).any()
    if N and (is_luma or is_chroma):
        subw = plan.sps.SubWidthC if plan.sps.ChromaArrayType else 1
        subh = plan.sps.SubHeightC if plan.sps.ChromaArrayType else 1
        scx = 1 if is_luma else subw
        scy = 1 if is_luma else subh
        if 4 // scx > 1 or 4 // scy > 1:
            ok = _border_ok_runs(plan, xs, ys, is_luma, subw, subh,
                                 scx, scy, log2)
            cache[key] = ok
            return ok
    ok = _border_ok_dense(plan, xs, ys, cidx_arr, log2)
    cache[key] = ok
    return ok


def _border_ok_runs(plan, xs, ys, is_luma, subw, subh, scx, scy, log2):
    """Run-granular availability (one decision per 4x4-grid-aligned run
    of border samples; run lengths are per-axis — 4:2:2 top runs are 2
    samples, left runs 4). Correct because the z-scan frontier, slice
    ids and tile ids are all constant within one 4x4-luma cell, and TU
    origins/plane dims are run-aligned."""
    zg, sa4, tid4 = _avail_grids(plan)
    gh, gw = zg.shape
    n = 1 << log2
    c = 2 * n
    gy, gx = 4 // scy, 4 // scx           # run lengths (left | top)
    nbl, nbt = c // gy, c // gx           # runs per segment
    x = xs.astype(np.int32)[:, None]
    y = ys.astype(np.int32)[:, None]
    N = x.shape[0]
    Hp = plan.H if is_luma else plan.H // subh
    Wp = plan.W if is_luma else plan.W // subw
    kl = np.arange(nbl, dtype=np.int32)[None, :]
    kt = np.arange(nbt, dtype=np.int32)[None, :]
    # run representatives: left runs in pos order (bottom-up), corner,
    # top runs left-to-right; left run k covers samples
    # by in [y + c - gy*(k+1), ...+gy) at bx = x-1
    by = np.concatenate([y + (c - gy * (kl + 1)),
                         y - 1,
                         np.broadcast_to(y - 1, (N, nbt))], axis=1)
    bx = np.concatenate([np.broadcast_to(x - 1, (N, nbl)),
                         x - 1,
                         x + gx * kt], axis=1)
    inb = (bx >= 0) & (by >= 0) & (bx < Wp) & (by < Hp)
    nby = np.clip((by * scy) >> 2, 0, gh - 1)
    nbx = np.clip((bx * scx) >> 2, 0, gw - 1)
    cby = (y * scy) >> 2
    cbx = (x * scx) >> 2
    okb = (inb & (zg[nby, nbx] < zg[cby, cbx])
           & (sa4[nby, nbx] == sa4[cby, cbx])
           & (tid4[nby, nbx] == tid4[cby, cbx]))
    if plan.pps.constrained_intra_pred_flag:
        okb &= plan.pred_mode[nby, nbx] == MODE_INTRA
    return np.concatenate([np.repeat(okb[:, :nbl], gy, axis=1),
                           okb[:, nbl:nbl + 1],
                           np.repeat(okb[:, nbl + 1:], gx, axis=1)],
                          axis=1)


def _border_ok_dense(plan, xs, ys, cidx_arr, log2):
    """Per-sample reference implementation (mixed-plane batches and the
    differential oracle for _border_ok_runs)."""
    zg, sa4, tid4 = _avail_grids(plan)
    gh, gw = zg.shape
    subw = plan.sps.SubWidthC if plan.sps.ChromaArrayType else 1
    subh = plan.sps.SubHeightC if plan.sps.ChromaArrayType else 1
    scx = np.where(cidx_arr == 0, 1, subw).astype(np.int64)[:, None]
    scy = np.where(cidx_arr == 0, 1, subh).astype(np.int64)[:, None]
    n = 1 << log2
    Lb = 4 * n + 1
    c = 2 * n
    pos = np.arange(Lb, dtype=np.int64)[None, :]
    x = xs.astype(np.int64)[:, None]
    y = ys.astype(np.int64)[:, None]
    by = np.where(pos < c, y + c - pos - 1, y - 1)
    bx = np.where(pos > c, x + pos - c - 1, x - 1)
    # plane bounds (own sample units; per-axis scale — 4:2:2 halves
    # only horizontally)
    Hp_l = np.where(cidx_arr == 0, plan.H, plan.H // subh)[:, None]
    Wp_l = np.where(cidx_arr == 0, plan.W, plan.W // subw)[:, None]
    inb = (bx >= 0) & (by >= 0) & (bx < Wp_l) & (by < Hp_l)
    nby = np.clip((by * scy) >> 2, 0, gh - 1)
    nbx = np.clip((bx * scx) >> 2, 0, gw - 1)
    cby = np.clip((y * scy) >> 2, 0, gh - 1)
    cbx = np.clip((x * scx) >> 2, 0, gw - 1)
    ok = (inb & (zg[nby, nbx] < zg[cby, cbx])
          & (sa4[nby, nbx] == sa4[cby, cbx])
          & (tid4[nby, nbx] == tid4[cby, cbx]))
    if plan.pps.constrained_intra_pred_flag:
        ok &= plan.pred_mode[nby, nbx] == MODE_INTRA
    return ok


def intra_frame_stats(plan):
    """Per-class level histogram for stream_cfg capacity derivation.
    Returns (n_levels, {(pl, log2): (max_per_level, total, n_escapes,
    kind_mask)}); kind_mask bit0 = transform-skip present, bit1 =
    tq-bypass present."""
    tm, coeff_pool, _ = plan._tu_arrays
    levels = assign_levels(plan)[0]
    out = {}
    n_levels = int(levels.max()) if levels.size else 0
    for log2 in INTRA_LOG2S:
        for pl in (0, 1):
            sel = ((levels > 0) & (tm[:, 3] == log2)
                   & ((tm[:, 0] == 0) if pl == 0 else (tm[:, 0] > 0)))
            k = int(sel.sum())
            if not k:
                continue
            lv = levels[sel]
            cnt = np.bincount(lv)
            ne = 0
            co = tm[sel, 9]
            has = co >= 0
            if has.any():
                nn = 1 << (2 * log2)
                gi = co[has][:, None] + np.arange(nn)[None, :]
                cgi = coeff_pool[gi]
                ne = int(((cgi < -8) | (cgi > 7)).sum())
            kinds = (1 if (tm[sel, 6] != 0).any() else 0) | \
                (2 if (tm[sel, 7] != 0).any() else 0)
            out[(pl, log2)] = (int(cnt.max()), k, ne, kinds)
    return n_levels, out


def _cumcount(sorted_keys):
    """Position of each element within its equal-key run (keys sorted)."""
    return np.arange(sorted_keys.size) - \
        np.searchsorted(sorted_keys, sorted_keys, side="left")


def pack_scan_perms(plan, cfg, cls_idx):
    """Host: slot permutations for the band-scan kernel
    (ops/kernels/intra_scan.py). TUs are ordered by (CTB row band,
    global z-scan address) — decode order within each tile, which the
    kernel's serial walk requires. Slot value = row_in_class*4 + rank;
    -1 = padding. Emits ispm_0 (luma) and ispm_b / ispm_r (chroma
    Cb/Cr pair rows; a chroma band is ctb // SubHeightC rows, and a
    chroma TU's z key is that of the luma sample at its origin). At 4:2:2
    a chroma TU is two stacked squares, the lower one reading the upper
    one's bottom row: its origin lies in the lower half of the same luma
    block, so its z key is larger and it follows the upper one."""
    t = {}
    zg4 = _avail_grids(plan)[0]
    tm = plan._tu_arrays[0]
    ctb = 1 << plan.sps.Log2CtbSizeY
    subw, subh = cfg.subw, cfg.subh
    NB = -(-plan.H // ctb)
    KL, KC = cfg.intra_scan[:2]
    lcls = [e[1] for e in cfg.intra if e[0] == 0]
    ccls = [e[1] for e in cfg.intra if e[0] == 1]

    # ---- luma
    bands, zgs, encs = [], [], []
    for rank, log2 in enumerate(lcls):
        idx = cls_idx.get((0, log2))
        if idx is None or not idx.size:
            continue
        y = tm[idx, 2].astype(np.int64)
        x = tm[idx, 1].astype(np.int64)
        bands.append(y // ctb)
        zgs.append(zg4[y >> 2, x >> 2])
        encs.append(np.arange(idx.size, dtype=np.int64) * 4 + rank)
    perm = np.full(NB * KL, -1, np.int32)
    if bands:
        b = np.concatenate(bands)
        z = np.concatenate(zgs)
        e = np.concatenate(encs)
        o = np.lexsort((z, b))
        b, e = b[o], e[o]
        pos = _cumcount(b)
        assert pos.max() < KL, (int(pos.max()), KL)
        perm[b * KL + pos] = e
    t["ispm_0"] = perm

    # ---- chroma: pair Cb/Cr rows of each class by position
    if ccls and KC:
        bandsc, zgsc, encb, encr = [], [], [], []
        bh_c = ctb // subh
        for rank, log2 in enumerate(ccls):
            idx = cls_idx.get((1, log2))
            if idx is None or not idx.size:
                continue
            cidx = tm[idx, 0]
            x = tm[idx, 1].astype(np.int64)
            y = tm[idx, 2].astype(np.int64)
            # pair Cb/Cr rows by position: sort by (x, y, cidx) so each
            # pair is adjacent with Cb (cidx 1) first
            o = np.lexsort((cidx, y, x))
            rb, rr = o[0::2], o[1::2]
            assert (cidx[rb] == 1).all() and (cidx[rr] == 2).all() \
                and (x[rb] == x[rr]).all() and (y[rb] == y[rr]).all()
            px, py = x[rb], y[rb]
            bandsc.append(py // bh_c)
            zgsc.append(zg4[(py * subh) >> 2, (px * subw) >> 2])
            encb.append(rb * 4 + rank)
            encr.append(rr * 4 + rank)
        pb = np.full(NB * KC, -1, np.int32)
        pr = np.full(NB * KC, -1, np.int32)
        if bandsc:
            b = np.concatenate(bandsc)
            z = np.concatenate(zgsc)
            eb = np.concatenate(encb)
            er = np.concatenate(encr)
            o = np.lexsort((z, b))
            b, eb, er = b[o], eb[o], er[o]
            if (subw, subh) == (2, 1):
                _assert_lower_follows(eb, tm, cls_idx, ccls)
            pos = _cumcount(b)
            assert pos.max() < KC, (int(pos.max()), KC)
            pb[b * KC + pos] = eb
            pr[b * KC + pos] = er
        t["ispm_b"] = pb
        t["ispm_r"] = pr
    return t


def _assert_lower_follows(eb, tm, cls_idx, ccls):
    """4:2:2: in the (band, z)-sorted Cb slots `eb`, the square right
    below a square of the same size (the lower half of its TU, or a TU
    below it) comes later."""
    rank = eb & 3
    rows = np.concatenate([cls_idx[(1, l)] for l in ccls])
    base = np.cumsum([0] + [cls_idx[(1, l)].size for l in ccls])[:-1]
    row = rows[base[rank] + (eb >> 2)]
    n = np.asarray([1 << l for l in ccls], np.int64)[rank]
    x, y = tm[row, 1].astype(np.int64), tm[row, 2].astype(np.int64)
    key = (x << 32 | y) * 4 + rank
    below = (x << 32 | (y + n)) * 4 + rank
    order = np.argsort(key)
    j = np.searchsorted(key[order], below)
    hit = j < key.size
    hit[hit] = key[order[j[hit]]] == below[hit]
    assert (order[j[hit]] > np.flatnonzero(hit)).all()


def pack_intra(plan, cfg):
    """Host: per-class flat level-sorted tensors for the device scan.
    Emits (into a dict) for each cfg.intra class (pl, log2, Ktot, Klvl, E):
      ixy_{pl}_{l}: (Ktot,2) int16 x,y (plane units)
      imd_{pl}_{l}: (Ktot,)  int8  mode
      iok_{pl}_{l}: (Ktot,OB) uint8 packed border-availability bits
      ipl_{pl}_{l}: (Ktot,)  int8  cidx (chroma classes only)
      icf_{pl}_{l}: (Ktot,n*n) int8 coeff body (+ iei/iev escapes when E)
      iqp_{pl}_{l}: (Ktot,)  int8  QP
      ioff_{pl}_{l}: (C+1,) int32 level offsets"""
    t = {}
    tm, coeff_pool, _ = plan._tu_arrays
    levels = assign_levels(plan)[0]
    C = cfg.intra_C
    cls_idx = {}
    for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
        n = 1 << log2
        nn = n * n
        OB = _okbytes(log2)
        sel = ((levels > 0) & (tm[:, 3] == log2)
               & ((tm[:, 0] == 0) if pl == 0 else (tm[:, 0] > 0)))
        idx = np.flatnonzero(sel)
        # availability in flatnonzero order: shares the memoized result
        # with stream_cfg's hole probe (same batch), permuted below
        ok0 = border_ok(plan, tm[idx, 1], tm[idx, 2], tm[idx, 0],
                         log2) if idx.size else None
        lv = levels[idx]
        order = np.argsort(lv, kind="stable")
        idx = idx[order]
        lv = lv[order]
        k = idx.size
        cls_idx[(pl, log2)] = idx
        assert k + Klvl <= Ktot, (pl, log2, k, Klvl, Ktot)
        cnt = np.bincount(lv, minlength=C + 1)
        assert lv.size == 0 or (int(lv.max()) <= C
                                and int(cnt[1:].max()) <= Klvl), \
            (pl, log2, C, Klvl)
        off = np.zeros(C + 1, np.int32)
        off[1:] = np.cumsum(cnt[1:C + 1])
        xy = np.zeros((Ktot, 2), np.int16)
        xy[:k, 0] = tm[idx, 1]
        xy[:k, 1] = tm[idx, 2]
        md = np.ones(Ktot, np.int8)
        md[:k] = tm[idx, 4]
        okb = np.zeros((Ktot, OB), np.uint8)
        if k:
            okb[:k] = np.packbits(ok0[order], axis=1)
        qp = np.zeros(Ktot, np.int8)
        qp[:k] = tm[idx, 5]
        if kinds:
            kd = np.zeros(Ktot, np.int8)
            kd[:k] = np.where(tm[idx, 7] != 0, 2,
                              np.where(tm[idx, 6] != 0, 1, 0))
            t[f"ikd_{pl}_{log2}"] = kd
        cf = np.zeros((Ktot, nn), np.int16)
        co = tm[idx, 9]
        has = co >= 0
        if has.any():
            gi = co[has][:, None] + np.arange(nn)[None, :]
            cf[np.flatnonzero(has)] = coeff_pool[gi]
        # 4-bit nibble body + escapes, mirroring the inter residual
        # buckets (99.7% of levels fit [-8,7]; halves the I-frame's
        # dominant upload tensor)
        cnib = (cf & 15).astype(np.uint8)
        c8 = cnib[:, 0::2] | (cnib[:, 1::2] << 4)     # (Ktot, nn//2)
        sfx = f"_{pl}_{log2}"
        if E:
            flat = cf.reshape(-1)
            eidx = np.flatnonzero((flat < -8) | (flat > 7))
            assert eidx.size <= E, (pl, log2, eidx.size, E)
            ridx = np.full(E, Ktot * nn, np.int32)
            rval = np.zeros(E, np.int16)
            ridx[:eidx.size] = eidx
            rval[:eidx.size] = flat[eidx]
            t["iei" + sfx] = ridx
            t["iev" + sfx] = rval
        else:
            assert bool(((cf >= -8) & (cf <= 7)).all()), \
                "intra escape capacity 0 but levels outside [-8,7]"
        t["ixy" + sfx] = xy
        t["imd" + sfx] = md
        t["iok" + sfx] = okb
        t["iqp" + sfx] = qp
        t["icf" + sfx] = c8
        t["ioff" + sfx] = off
        if pl == 1:
            ip = np.ones(Ktot, np.int8)
            ip[:k] = tm[idx, 0]
            t["ipl" + sfx] = ip
    if getattr(cfg, "intra_scan", ()):
        t.update(pack_scan_perms(plan, cfg, cls_idx))
    return t


# ------------------------------------------------------------- device side
def unnibble(b):
    """uint8 nibble pairs (..., m) -> int32 (..., 2m) of the 4-bit two's
    complement values, low nibble first."""
    b = b.to(torch.int32)
    lo = ((b & 15) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], -1)


def unpack_bits(a, nbits):
    """(R, B) uint8 packed bits (numpy packbits' big bit order) ->
    (R, nbits) int32 0/1."""
    sh = 7 - torch.arange(8, dtype=torch.int32, device=a.device)
    bits = (a.to(torch.int32)[:, :, None] >> sh) & 1
    return bits.reshape(a.shape[0], -1)[:, :nbits]


def _residuals(t, cfg):
    """Batched per-class dequant + inverse transforms (level-independent,
    so one batch per class; DST for 4x4 luma), with scaling lists and the
    per-TU transform-skip / transquant-bypass select."""
    bd = cfg.bitdepth
    res_all = {}
    for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
        n = 1 << log2
        nn = n * n
        sfx = f"_{pl}_{log2}"
        c = unnibble(t["icf" + sfx])                      # (Ktot, nn)
        if E:
            # escapes: (idx, value) repairs of the out-of-nibble levels;
            # padding entries point at one dump element past the end
            fl = torch.cat([c.reshape(-1), c.new_zeros(1)])
            fl[t["iei" + sfx].to(torch.int64)] = \
                t["iev" + sfx].to(torch.int32)
            c = fl[:Ktot * nn]
        c = c.reshape(Ktot, n, n)
        qpv = t["iqp" + sfx].to(torch.int32)
        is_dst = pl == 0 and log2 == 2
        smat = None
        if cfg.scaling:
            smat = t["ism" + sfx]
            if pl == 1:       # per-row Cb/Cr matrix select
                smat = smat[t["ipl" + sfx].to(torch.int64) - 1]
            res = residual_batch_sl(c, qpv, smat, log2, is_dst, bd)
        else:
            res = residual_batch(c, qpv, log2, is_dst, bd)
        if kinds:
            res = residual_kinds(res, c, qpv, smat, t["ikd" + sfx], kinds,
                                 log2, bd)
        res_all[sfx] = res
    return res_all


def _ftab(log2s, smooth):
    """filterFlag per (class rank, mode), spec 8.4.4.2.3: n >= 8, not DC,
    minDist(mode, {10, 26}) above the size threshold, where the plane is
    smoothed at all (`smooth`: luma, or chroma at 4:4:4, cIdx == 0 ||
    ChromaArrayType == 3)."""
    ftab = np.zeros((len(log2s), 35), np.int32)
    if smooth:
        md = np.minimum(abs(np.arange(35) - 26), abs(np.arange(35) - 10))
        for ci, l in enumerate(log2s):
            n = 1 << l
            if n >= 8:
                ftab[ci] = (np.arange(35) != 1) & \
                    (md > {8: 7, 16: 1, 32: 0}[n])
    return ftab.reshape(-1)


def avail_spans(avail):
    """(rows, 256) 0/1 availability -> (rows,) int32 pack_span: the
    available samples' run [a, b), anyok, and whether the run has holes
    (contiguous runs substitute by two clamps)."""
    total = avail.sum(1)
    anyok = total > 0
    first = torch.argmax(avail, dim=1)
    last = 255 - torch.argmax(avail.flip(1), dim=1)
    a_ = torch.where(anyok, first, 0)
    b_ = torch.where(anyok, last + 1, 0)
    hole = anyok & (total != b_ - a_)
    return pack_span(a_, b_, anyok.to(torch.int64),
                     hole.to(torch.int64)).to(torch.int32)


def _pad_cols(a, width):
    """(N, w) -> (N, width), zero columns on the right; `a` itself when
    w == width (a zero pad would copy it: a device-to-device memcpy)."""
    return a if a.shape[1] == width else \
        torch.nn.functional.pad(a, (0, width - a.shape[1]))


def _group_inputs(t, cfg, res_all, pl, classes, K, BH, BW, perms):
    """Kernel inputs (intra_scan keyword arguments, planes aside) of one
    plane group: residual and availability pools in class-row order, the
    slot records, and the per-plane slot -> pool-row maps."""
    dev = res_all[f"_{pl}_{classes[0][1]}"].device
    log2s = tuple(e[1] for e in classes)
    Ktots = [e[2] for e in classes]
    RW = max(256, max(1 << (2 * l) for l in log2s))
    respool, avpool = [], []
    for l, kt in zip(log2s, Ktots):
        nsq = 1 << (2 * l)
        r = res_all[f"_{pl}_{l}"].reshape(kt, nsq)
        respool.append(_pad_cols(r, RW))
        bits = unpack_bits(t[f"iok_{pl}_{l}"], 8 * _okbytes(l))
        avpool.append(_pad_cols(bits, 256))
    avail = torch.cat(avpool)
    xcat = torch.cat([t[f"ixy_{pl}_{l}"][:, 0] for l in log2s]).to(
        torch.int64)
    ycat = torch.cat([t[f"ixy_{pl}_{l}"][:, 1] for l in log2s]).to(
        torch.int64)
    mcat = torch.cat([t[f"imd_{pl}_{l}"] for l in log2s]).to(torch.int64)
    base_rows = device_table(("base_rows", tuple(Ktots)),
                             np.cumsum([0] + Ktots)[:-1], dev)
    smooth = pl == 0 or cfg.chroma_fmt == 3
    ftab = device_table(("ftab", log2s, smooth),
                        _ftab(log2s, smooth).astype(np.int64), dev)
    nrows = xcat.shape[0]

    def rowg_of(pm):
        pmc = torch.clamp(pm.to(torch.int64), min=0)
        return torch.clamp(base_rows[pmc & 3] + (pmc >> 2), 0, nrows - 1)
    # records from the first perm (Cb row geometry == Cr's)
    p0 = perms[0].to(torch.int64)
    rank = torch.clamp(p0, min=0) & 3
    rowg = rowg_of(p0)
    mode = mcat[rowg]
    recs = pack_rec(xcat[rowg], ycat[rowg] % BH, rank, mode,
                    (p0 >= 0).to(torch.int64), ftab[rank * 35 + mode])
    rowgs = [rowg] + [rowg_of(pm) for pm in perms[1:]]
    return dict(recs=recs.to(torch.int32).contiguous(),
                rowgs=[r.to(torch.int32).contiguous() for r in rowgs],
                spans=avail_spans(avail).contiguous(),
                avail=avail.to(torch.uint8).contiguous(),
                resid=torch.cat(respool).contiguous(), log2s=log2s, K=K,
                BH=BH, BW=BW, strong=cfg.strong, luma=pl == 0,
                bitdepth=cfg.bitdepth)


def scan_groups(t, cfg):
    """[(plane indices, intra_scan kwargs)] for the frame's plane groups:
    luma alone ((0,)), then Cb with Cr ((1, 2)) unless monochrome. The
    bands are a CTB tall and its columns a CTB wide, in the plane's own
    samples (a 4:2:2 chroma CTB is ctb / 2 wide and ctb tall)."""
    res_all = _residuals(t, cfg)
    ctb = 1 << cfg.log2ctb
    KL, KC = cfg.intra_scan[:2]
    lcls = [e for e in cfg.intra if e[0] == 0]
    ccls = [e for e in cfg.intra if e[0] == 1]
    out = []
    if lcls:
        out.append(((0,), _group_inputs(t, cfg, res_all, 0, lcls, KL, ctb,
                                        ctb, [t["ispm_0"]])))
    if ccls and KC:
        out.append(((1, 2), _group_inputs(t, cfg, res_all, 1, ccls, KC,
                                          ctb // cfg.subh, ctb // cfg.subw,
                                          [t["ispm_b"], t["ispm_r"]])))
    return out


def intra_stage_scan(Y, Cb, Cr, t, cfg):
    """Reconstruct every intra TU of the frame with the band-scan kernel
    (one launch per plane group). Planes arrive with inter prediction +
    inter residuals applied and are updated in place; returns (Y, Cb,
    Cr). Kernel inputs come from the packed class tensors, reordered by
    the host ispm_* permutations."""
    planes = (Y, Cb, Cr)
    for idx, kw in scan_groups(t, cfg):
        intra_scan([planes[i] for i in idx], **kw)
    return Y, Cb, Cr
