"""K4: intra reconstruction over (CTB-row band, TU slot) as a wavefront
across bands (csrc/intra_scan.cu).

Replaces libde265_tpu/ops/pallas/intra_scan.py:build_scan. `intra_scan`
launches the CUDA kernel (one thread block per band, each slot waiting
on the band above as `band_waits` says) for CUDA tensors and runs
`intra_scan_plain`, the same function in plain PyTorch (one TU at a
time, in slot order), for CPU tensors; `intra_scan.launches` counts
kernel launches.

Inputs (assembled by intra_fused.intra_stage_scan from the packed plan):
  planes : 1 (luma) or 2 (Cb, Cr) (H, W) int32 planes, updated in place
  recs   : (NB*K,) int32 pack_rec records in slot order; slot t belongs to
           band t // K, so the TU origin is y = (t // K) * BH + yin
  rowgs  : per plane, (NB*K,) int32 row of the slot's TU in the pools
  spans  : (rows,) int32 pack_span of each pool row's availability
  avail  : (rows, 256) uint8 0/1 border availability in spec scan order
  resid  : (rows, RW) int32 residuals, row-major n x n
Availability and spans are read through the first plane's rows (Cb and
Cr TUs share geometry).
"""
import ctypes

import numpy as np
import torch

from ... import _build
from ...convert import device_table
from ..intra_ref import INTRA_PRED_ANGLE, INV_ANGLE

_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4


# one packed int32 record per TU slot (ops/pallas/intra_scan.py:50-60):
#   x:13 | yin:6 | cls:2 | mode:6 | valid:1 | fflag:1
def pack_rec(x, yin, cls, mode, valid, fflag):
    return (x | (yin << 13) | (cls << 19) | (mode << 21)
            | (valid << 27) | (fflag << 28))


# packed availability span:  a:8 | b:9 | anyok:1 | hole:1 — the available
# border samples form one contiguous run [a, b) unless `hole`
def pack_span(a, b, anyok, hole):
    return a | (b << 8) | (anyok << 17) | (hole << 18)


_TABLES = {}


def _pred_tables(log2, mode):
    """Index/weight tables of one (size, mode) prediction over the
    filtered border F (spec 8.4.4.2.4-6, before boundary filters):
    angular: pred = ((32 - f) * F[ia] + f * F[ib] + 16) >> 5."""
    key = (log2, mode)
    if key not in _TABLES:
        n = 1 << log2
        c2, L = 2 * n, 4 * n + 1
        angle = INTRA_PRED_ANGLE[mode - 2]
        inv = INV_ANGLE[mode - 11] if angle < 0 else 0
        vert = mode >= 18
        r = np.arange(n)[:, None]
        c = np.arange(n)[None, :]
        i, j = (r, c) if vert else (c, r)
        pos = (i + 1) * angle
        idx, fact = pos >> 5, pos & 31

        def main_ref(k):
            q = (k * inv + 128) >> 8
            jj = np.where(k >= 0, c2 + k if vert else c2 - k,
                          c2 - q if vert else c2 + q)
            return np.clip(jj, 0, L - 1)
        _TABLES[key] = (main_ref(j + idx + 1), main_ref(j + idx + 2),
                        np.broadcast_to(fact, (n, n)).copy())
    return _TABLES[key]


def _border_index(n, y, x, H, W):
    c2, L = 2 * n, 4 * n + 1
    k = np.arange(L)
    yy = np.where(k < c2, y + c2 - 1 - k, y - 1)
    xx = np.where(k < c2, x - 1, x + k - c2 - 1)
    return np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)


def _subst_index(L, sp, ok):
    """Source lane of each border lane after substitution (8.4.4.2.2),
    or None when nothing is available. ok: (256,) 0/1 numpy row."""
    a, b = sp & 255, (sp >> 8) & 511
    anyok, hole = (sp >> 17) & 1, (sp >> 18) & 1
    if not anyok:
        return None
    k = np.arange(L)
    if not hole:
        return np.where(k < a, a, np.where(k >= b, b - 1, k))
    # forward fill from the last available lane; the leading gap takes
    # the first available one
    av = ok[:L] != 0
    last = np.maximum.accumulate(np.where(av, k, -1))
    return np.where(last >= 0, last, int(np.argmax(av)))


def band_waits(recs, K, BH):
    """(NB*K,) int32 waits of the wavefront, on the records' device:
    need[t] is how many of band b-1's slots (b = t // K) must be finished
    before slot t may read the plane, 1 + the largest position p of a
    valid slot of band b-1 whose CTB column (x // BH) is at most slot t's
    plus one (the above-right CTB); 0 in band 0, for invalid slots, or
    when no such slot exists. Slots need not be in column order within
    a band (tile scan), so this is a scatter-max per (band, column) and
    a running max over the columns. A few launches and no host round
    trip: the frame program is bound by the host's launches."""
    K, BH = int(K), int(BH)
    NB = recs.shape[0] // K
    ncol = 8192 // BH + 2                   # x has 13 bits: col + 1 fits
    dev = recs.device
    # band b's column maxima go to row b + 1, read by band b + 1; row 0
    # (band -1) stays -1
    row = device_table(("k4_rows", NB, K, ncol),
                       np.repeat(np.arange(1, NB + 1) * ncol, K), dev)
    pos1 = device_table(("k4_pos1", NB, K),
                        np.tile(np.arange(1, K + 1, dtype=np.int32), NB),
                        dev)
    valid = (recs >> 27) & 1
    key = row + (recs & 0x1FFF) // BH
    last = torch.full(((NB + 1) * ncol,), -1, dtype=torch.int32, device=dev)
    last.scatter_reduce_(0, key, pos1 * valid - 1, "amax")
    upto = torch.cummax(last.view(NB + 1, ncol), dim=1).values.view(-1)
    return (upto[key - (ncol - 1)] + 1) * valid


def intra_scan_plain(planes, recs, rowgs, spans, avail, resid, log2s, K,
                     BH, strong, luma, bitdepth=8, order=None):
    """Plain PyTorch version of the kernel (same contract): one TU at a
    time in slot order, or in the slot order `order` (a permutation of
    the slots) where one is given."""
    maxv = (1 << bitdepth) - 1
    mid = 1 << (bitdepth - 1)
    H, W = planes[0].shape
    dev = planes[0].device
    nsl = recs.shape[0]
    recs_h = recs.cpu().numpy()
    rowg_h = [r.cpu().numpy() for r in rowgs]
    spans_h = spans.cpu().numpy()
    P = torch.stack(planes)                     # (np, H, W) working copy
    for t in range(nsl) if order is None else order:
        rec = int(recs_h[t])
        if not (rec >> 27) & 1:
            continue
        x = rec & 0x1FFF
        y = (t // K) * BH + ((rec >> 13) & 63)
        log2 = log2s[(rec >> 19) & 3]
        mode = (rec >> 21) & 63
        fflag = (rec >> 28) & 1
        n = 1 << log2
        c2, L = 2 * n, 4 * n + 1
        row0 = int(rowg_h[0][t])
        sp = int(spans_h[row0])
        yy, xx = _border_index(n, y, x, H, W)
        raw = P[:, torch.as_tensor(yy, device=dev),
                torch.as_tensor(xx, device=dev)]          # (np, L)
        src = _subst_index(L, sp, avail[row0].cpu().numpy()
                           if (sp >> 18) & 1 else None)
        if src is None:
            ref = torch.full_like(raw, mid)
        else:
            ref = raw[:, torch.as_tensor(src, device=dev)]
        F = ref
        if n >= 8 and fflag:
            r0 = ref[0].tolist()
            corner = r0[c2]
            bt = 1 << (bitdepth - 5)
            if strong and luma and n == 32 \
                    and abs(corner + r0[4 * n] - 2 * r0[c2 + n]) < bt \
                    and abs(corner + r0[0] - 2 * r0[c2 - n]) < bt:
                k = torch.arange(L, device=dev)
                di = (k - c2).abs()
                endv = torch.where(k > c2, ref[:, 4 * n:4 * n + 1],
                                   ref[:, 0:1])
                bil = ((2 * n - di) * ref[:, c2:c2 + 1] + di * endv + n) >> 6
                F = torch.where((di == 0) | (di == 2 * n), ref, bil)
            else:
                F = ref.clone()
                F[:, 1:L - 1] = (ref[:, :-2] + 2 * ref[:, 1:-1]
                                 + ref[:, 2:] + 2) >> 2
        top = F[:, c2 + 1:c2 + 1 + n]                    # p[c][-1]
        left = F[:, c2 - n:c2].flip(1)                   # p[-1][r]
        corner = F[:, c2:c2 + 1]
        fix = luma and n < 32
        if mode == 0:
            cc = torch.arange(n, device=dev)
            pred = ((n - 1 - cc)[None, None, :] * left[:, :, None]
                    + (cc + 1)[None, None, :] * F[:, c2 + n + 1, None, None]
                    + (n - 1 - cc)[None, :, None] * top[:, None, :]
                    + (cc + 1)[None, :, None] * F[:, c2 - n - 1, None, None]
                    + n) >> (log2 + 1)
        elif mode == 1:
            dc = (top.sum(1) + left.sum(1) + n) >> (log2 + 1)   # (np,)
            pred = dc[:, None, None].expand(-1, n, n).clone()
            if fix:
                pred[:, 0, :] = (top + 3 * dc[:, None] + 2) >> 2
                pred[:, :, 0] = (left + 3 * dc[:, None] + 2) >> 2
                pred[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        else:
            ia, ib, fact = (torch.as_tensor(a, device=dev)
                            for a in _pred_tables(log2, mode))
            pred = ((32 - fact) * F[:, ia] + fact * F[:, ib] + 16) >> 5
            if fix and mode == 26:
                pred[:, :, 0] = torch.clamp(
                    top[:, 0:1] + ((left - corner) >> 1), 0, maxv)
            if fix and mode == 10:
                pred[:, 0, :] = torch.clamp(
                    left[:, 0:1] + ((top - corner) >> 1), 0, maxv)
        res = torch.stack([resid[int(rg[t]), :n * n].view(n, n)
                           for rg in rowg_h])
        P[:, y:y + n, x:x + n] = torch.clamp(pred + res, 0, maxv)
    for p, out in zip(planes, P):
        p.copy_(out)
    return planes


def intra_scan(planes, recs, rowgs, spans, avail, resid, log2s, K, BH,
               strong, luma, bitdepth=8):
    """Kernel wrapper: same contract as intra_scan_plain."""
    if planes[0].device.type == "cpu":
        return intra_scan_plain(planes, recs, rowgs, spans, avail, resid,
                                log2s, K, BH, strong, luma, bitdepth)
    dev = planes[0].device
    H, W = planes[0].shape
    tensors = list(planes) + [recs, spans, avail, resid] + list(rowgs)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("intra_scan: all tensors must be on one CUDA "
                         "device")
    if len(planes) not in (1, 2) or len(rowgs) != len(planes):
        raise ValueError("intra_scan: 1 or 2 planes, one rowg per plane")
    if any(p.dtype != torch.int32 or p.shape != (H, W) for p in planes):
        raise TypeError("intra_scan: planes must be (H, W) int32")
    i32 = (recs, spans, resid) + tuple(rowgs)
    if any(t.dtype != torch.int32 for t in i32) \
            or avail.dtype != torch.uint8:
        raise TypeError("intra_scan: int32 records/pools, uint8 avail")
    nsl = recs.shape[0]
    if any(r.shape != (nsl,) for r in rowgs) or nsl % K \
            or avail.shape != (spans.shape[0], 256) \
            or resid.dim() != 2 or resid.shape[0] != spans.shape[0]:
        raise ValueError("intra_scan: inconsistent record/pool shapes")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("intra_scan: tensors must be contiguous")
    if not (1 <= len(log2s) <= 4 and all(2 <= l <= 5 for l in log2s)):
        raise ValueError(f"intra_scan: class sizes {log2s}")
    if resid.shape[1] < 1 << (2 * max(log2s)) or resid.shape[1] % 4 \
            or resid.data_ptr() % 16:
        raise ValueError("intra_scan: residual rows shorter than n*n, or "
                         "not in whole 16-byte pieces")
    if W > 8191 or BH > 64 or not 8 <= bitdepth <= 12:
        raise ValueError("intra_scan: record fields overflow (W <= 8191, "
                         "BH <= 64, 8..12-bit)")
    _launch(planes, recs, rowgs, spans, avail, resid, log2s, K, BH, strong,
            luma, bitdepth, band_waits(recs, K, BH))
    intra_scan.launches += 1
    return planes


def _launch(planes, recs, rowgs, spans, avail, resid, log2s, K, BH, strong,
            luma, bitdepth, need):
    """The kernel launch alone, with the waits already computed."""
    H, W = planes[0].shape
    dev = planes[0].device
    packed = sum(l << (8 * i) for i, l in enumerate(log2s))
    p1 = planes[1] if len(planes) == 2 else planes[0]
    r1 = rowgs[1] if len(rowgs) == 2 else rowgs[0]
    # [ticket, done[0], ..., done[NB - 1]], zeroed on the current stream
    sync = torch.zeros(1 + recs.shape[0] // K, dtype=torch.int32, device=dev)
    fn = _build.kernel_fn("k4_intra_scan", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(planes[0].data_ptr(), p1.data_ptr(), len(planes), H, W,
             recs.data_ptr(), rowgs[0].data_ptr(), r1.data_ptr(),
             spans.data_ptr(), avail.data_ptr(), resid.data_ptr(),
             resid.shape[1], packed, recs.shape[0], K, BH, int(strong),
             int(luma), bitdepth, need.data_ptr(), sync.data_ptr(),
             sync[1:].data_ptr(), stream)
    _build.check_launch("k4_intra_scan", err)


intra_scan.launches = 0
