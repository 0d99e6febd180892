"""Residual batches of the hybrid device path (PyTorch).

Counterpart of libde265_tpu/backend.py:29-97: a frame's inter TUs are
bucketed on the host (`pack_tu_batches`), each bucket's residuals come
from one batch on the device (ops/transform.tu_residuals, where the JAX
module jits ops/transform_jax.residual_batch as `residual_batch_device`)
and are added into the plane with the clip (`scatter_residuals`,
`add_frame_residuals`). device_decode.py is the hybrid path.
`reconstruct_frame_device` is the JAX module's whole-frame filter entry
(backend.py:99-112): the in-loop filters of a plan whose prediction and
residuals are already in `plan.planes`.
"""
import numpy as np
import torch

from .convert import to_tensor
from .device import resolve
from .ops.filters_fused import apply_filters_fused
from .ops.transform import tu_residuals
from .plan import MODE_INTER, TU_CIDX, TU_COFF, TU_LOG2, TU_PM, TU_X, TU_Y


def pack_tu_batches(meta):
    """Bucket the inter TUs with coefficients of a TU table
    (plan.tu_table) by (cidx, log2): {(cidx, log2): rows in decode
    order} for the non-empty buckets. The JAX function buckets by (log2,
    is_dst) over every plane; a bucket here also shares one scaling
    matrix."""
    sel = (meta[:, TU_CIDX] >= 0) & (meta[:, TU_COFF] >= 0) \
        & (meta[:, TU_PM] == MODE_INTER)
    out = {}
    for cidx in range(3):
        for log2 in (2, 3, 4, 5):
            rows = np.nonzero(sel & (meta[:, TU_CIDX] == cidx)
                              & (meta[:, TU_LOG2] == log2))[0]
            if rows.size:
                out[(cidx, log2)] = rows
    return out


def scatter_residuals(plane, res, xs, ys, log2, maxv):
    """Add the (K, n, n) blocks `res` into the int32 plane at the
    n-aligned (xs, ys) (K,) and clip to [0, maxv], in place; returns the
    plane. TUs never overlap, so the index write is unique."""
    n = 1 << log2
    W = plane.shape[1]
    ar = torch.arange(n, device=plane.device)
    idx = ((ys.to(torch.int64)[:, None, None] + ar[None, :, None]) * W
           + xs.to(torch.int64)[:, None, None] + ar[None, None, :])
    flat = plane.view(-1)
    flat[idx] = torch.clamp(flat[idx] + res, 0, maxv)
    return plane


def add_frame_residuals(plan, planes, meta, pool, bitdepth=8):
    """Add the inter TUs' residuals of the TU table (meta, coefficient
    pool) to the [Y, Cb, Cr] int32 device planes with the clip, in
    place: one residual batch and one scatter per bucket of
    pack_tu_batches."""
    maxv = (1 << bitdepth) - 1
    dev = planes[0].device
    for (cidx, log2), rows in pack_tu_batches(meta).items():
        res = tu_residuals(plan, meta, pool, rows, bitdepth, dev)
        scatter_residuals(planes[cidx], res, to_tensor(meta[rows, TU_X], dev),
                          to_tensor(meta[rows, TU_Y], dev), log2, maxv)
    return planes


def reconstruct_frame_device(plan, dpb=None, device=None):
    """Deblock (when a slice has it on) and then SAO (K3, when a slice
    has it on) the pre-filter [Y, Cb, Cr] planes in `plan.planes`, on
    `device`: by default the planes' own device where they are tensors,
    else "cuda". Sets `plan.planes` to the filtered int32 planes and
    returns them. `dpb` is unused, as in the JAX function."""
    planes = plan.planes
    if device is not None:
        dev = resolve(device)
    elif torch.is_tensor(planes[0]):
        dev = planes[0].device
    else:
        dev = resolve("cuda")
    planes = [p.to(dev, torch.int32) if torch.is_tensor(p)
              else to_tensor(np.asarray(p).astype(np.int32), dev)
              for p in planes]
    plan.planes = apply_filters_fused(plan, planes)
    return plan.planes
