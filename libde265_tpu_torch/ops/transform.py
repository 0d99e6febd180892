"""Batched dequant + inverse transform (spec 8.6.2-8.6.4), bit-exact.

Counterpart of libde265_tpu/ops/transform_jax.py on (N, n, n) int32
batches, one TU size class per call.

The 1-D transforms are matmuls. CUDA has no int32 matmul, so both
stages run in float64, which is exact here: the stage-1 input is clipped
to 16 bits and every DCT/DST entry is at most 90 in magnitude, so each
partial sum is below 32 * 90 * 2^15 < 2^27, and stage 2 sums 16-bit
clipped values the same way; float64 holds every integer below 2^53.

`tu_residuals` gives the residuals of a list of the plan's TUs of one
class (the hybrid device path's inter and intra stages): one batch, the
per-TU kinds selected as the frame program selects them, and the numpy
reference for the TUs no batch form covers.

The dequant (flat or scaling-list) runs in int64. The JAX version asks
for int64 too but runs with x64 off, so it wraps in int32 once
|coeff * factor| reaches 2^31; where the two differ the stream's MD5
decides (ROADMAP queue 3).
"""
import numpy as np
import torch

from ..convert import device_table, to_tensor
from ..plan import (MODE_INTRA, TU_CIDX, TU_COFF, TU_LOG2, TU_PM, TU_QP,
                    TU_RDPCM, TU_TQB, TU_TSKIP, gather_coeffs)
from .transform_ref import (dct_matrix, DST4, LEVEL_SCALE,
                            scale_and_inv_transform, scaling_matrix)

LEVEL_SCALE_ARR = np.array(LEVEL_SCALE, np.int64)
MATRICES = {(2, True): np.asarray(DST4, np.float64)}
MATRICES.update({(l, False): np.asarray(dct_matrix(1 << l), np.float64)
                 for l in (2, 3, 4, 5)})


def _matrix(log2, is_dst, device):
    return device_table(("T", log2, is_dst), MATRICES[(log2, is_dst)],
                        device)


def dequant_batch(coeffs, qp, log2, bitdepth=8):
    """coeffs: (N,n,n) int32; qp: (N,) int. Returns (N,n,n) int32."""
    bd_shift = bitdepth + log2 - 5
    qp = qp.to(torch.int64)
    ls = device_table("LEVEL_SCALE", LEVEL_SCALE_ARR, coeffs.device)
    factor = (16 * ls[qp % 6]) << (qp // 6)                  # (N,)
    d = (coeffs.to(torch.int64) * factor[:, None, None]
         + (1 << (bd_shift - 1))) >> bd_shift
    return torch.clamp(d, -32768, 32767).to(torch.int32)


def dequant_batch_sl(coeffs, qp, smat, log2, bitdepth=8):
    """Scaling-list dequant (spec 8.6.3 with m[x][y]): smat is the (n,n)
    or (N,n,n) scale matrix, its DC already substituted on the host.
    Returns (N,n,n) int32."""
    bd_shift = bitdepth + log2 - 5
    qp = qp.to(torch.int64)
    ls = device_table("LEVEL_SCALE", LEVEL_SCALE_ARR, coeffs.device)
    if smat.dim() == 2:
        smat = smat[None]
    prod = coeffs.to(torch.int64) * smat.to(torch.int64) \
        * ls[qp % 6][:, None, None]
    d = ((prod << (qp // 6)[:, None, None]) + (1 << (bd_shift - 1))) \
        >> bd_shift
    return torch.clamp(d, -32768, 32767).to(torch.int32)


def inv_transform_batch(d, log2, is_dst, bitdepth=8):
    """(N,n,n) int32 dequantized coeffs -> (N,n,n) int32 residual."""
    mat = _matrix(log2, is_dst, d.device)
    shift2 = 20 - bitdepth
    # stage 1 (vertical): e = M^T @ d, clip to 16 bit after >>7
    e = torch.einsum("kj,nkx->njx", mat, d.to(torch.float64))
    e = torch.clamp((e.to(torch.int64) + 64) >> 7, -32768, 32767)
    # stage 2 (horizontal): r = e @ M
    r = torch.einsum("njx,xi->nji", e.to(torch.float64), mat)
    r = (r.to(torch.int64) + (1 << (shift2 - 1))) >> shift2
    return torch.clamp(r, -32768, 32767).to(torch.int32)


def transform_skip_batch(d, log2, bitdepth=8):
    """Transform-skip residual (spec 8.6.4.2 with extended_precision
    off): (d << (5 + log2)) rounded down by 20 - bitdepth, as the numpy
    reference (transform_ref.transform_skip_residual) has it. The JAX
    function shifts by 7, the 4x4 shift, at every size (ROADMAP queue
    3)."""
    shift = 20 - bitdepth
    r = d.to(torch.int64) << (5 + log2)
    r = (r + (1 << (shift - 1))) >> shift
    return torch.clamp(r, -32768, 32767).to(torch.int32)


def residual_batch(coeffs, qp, log2, is_dst, bitdepth=8):
    """Fused dequant + inverse transform for one TU size bucket."""
    d = dequant_batch(coeffs, qp, log2, bitdepth)
    return inv_transform_batch(d, log2, is_dst, bitdepth)


def residual_batch_sl(coeffs, qp, smat, log2, is_dst, bitdepth=8):
    """residual_batch with a scaling-list dequant."""
    d = dequant_batch_sl(coeffs, qp, smat, log2, bitdepth)
    return inv_transform_batch(d, log2, is_dst, bitdepth)


def residual_kinds(res, c, qp, smat, kd, kinds, log2, bitdepth=8):
    """Per-TU residual kind select over a bucket's transform residuals
    `res`: kd (N,) is 1 for transform-skip (the (scaling-list) dequant,
    then the skip shift) and 2 for transquant bypass (the raw levels `c`);
    `kinds` is the bucket's static bitmask of the kinds present (smat
    None: flat dequant)."""
    kd = kd.to(torch.int32)[:, None, None]
    if kinds & 1:
        d = dequant_batch(c, qp, log2, bitdepth) if smat is None \
            else dequant_batch_sl(c, qp, smat, log2, bitdepth)
        res = torch.where(kd == 1, transform_skip_batch(d, log2, bitdepth),
                          res)
    if kinds & 2:
        res = torch.where(kd == 2, c.to(torch.int32), res)
    return res


def tu_residuals(plan, meta, pool, rows, bitdepth, device):
    """(K, n, n) int32 residuals on `device` of the TU-table rows `rows`
    (plan.tu_table's meta and coefficient pool; one plane, one size, one
    prediction mode, every row with coefficients), in their order: the
    dequant (with the frame's scaling matrix where the SPS enables
    scaling lists) and inverse transform in one batch, transform-skip and
    bypass TUs through residual_kinds. Explicit-RDPCM TUs take the numpy
    reference per TU, uploaded in one copy."""
    m = meta[rows]
    cidx, log2 = int(m[0, TU_CIDX]), int(m[0, TU_LOG2])
    intra = bool(m[0, TU_PM] == MODE_INTRA)
    is_dst = intra and cidx == 0 and log2 == 2
    sps = plan.sps
    smat = sdc = sm = None
    if sps.scaling_list_enable_flag:
        sl = plan.pps.scaling_list \
            if plan.pps.pic_scaling_list_data_present_flag \
            else sps.scaling_list
        smat, sdc = scaling_matrix(sl, log2, cidx, intra)
        sm = smat.copy()
        if sdc is not None:
            sm[0, 0] = sdc
        sm = to_tensor(sm, device)
    coeffs = gather_coeffs(pool, m[:, TU_COFF], log2)
    c = to_tensor(coeffs, device)
    qp = to_tensor(m[:, TU_QP], device)
    res = residual_batch(c, qp, log2, is_dst, bitdepth) if sm is None \
        else residual_batch_sl(c, qp, sm, log2, is_dst, bitdepth)
    kd = np.where(m[:, TU_TQB] != 0, 2,
                  np.where(m[:, TU_TSKIP] != 0, 1, 0)).astype(np.int8)
    kinds = int((kd == 1).any()) | 2 * int((kd == 2).any())
    if kinds:
        res = residual_kinds(res, c, qp, sm, to_tensor(kd, device), kinds,
                             log2, bitdepth)
    host = np.nonzero(m[:, TU_RDPCM] > 0)[0]
    if host.size:
        blocks = [scale_and_inv_transform(
            coeffs[i], int(m[i, TU_QP]), log2, is_dst, bool(kd[i] == 1),
            bool(kd[i] == 2), bitdepth, smat, sdc,
            rdpcm=max(int(m[i, TU_RDPCM]), 0)) for i in host]
        res[to_tensor(host, device)] = to_tensor(
            np.stack(blocks).astype(np.int32), device)
    return res
