"""The hybrid device path: a frame that the fused frame program refuses,
reconstructed stage by stage on the decoder's device (PyTorch).

Counterpart of libde265_tpu/device_decode.py:13-95, with its stage
order: dense MC -> inter TU residuals + PCM paste -> intra by wavefront
levels -> deblocking, then SAO. device_stream.DeviceStreamDecoder routes
here the frames that frame_compatible refuses and that use none of the
tools only the numpy reference implements (packing.frame_uses_rext_tools):
TU-level chroma QP offsets and explicit RDPCM.

The planes are int32 tensors on the decoder's device from the first
stage to the DPB insert (the JAX version round-trips them to numpy
between stages); MC reads the references from the DPB stacks at their
slots, and the insert (`_do_insert`) refreshes the tile tables with K1.
SAO runs K3. A frame runs in the telemetry span "hybrid" (telemetry.py)
and each stage in a span inside it named after the stage (STAGES, then
"insert").
"""
import numpy as np
import torch

from . import telemetry
from .backend import add_frame_residuals
from .convert import to_tensor
from .ops.filters_fused import apply_filters_fused
from .ops.inter_dense import motion_compensate_frame_dense
from .ops.intra import intra_reconstruct_device
from .plan import TU_CIDX, TU_COFF, TU_LOG2, TU_X, TU_Y, tu_table


def dense_mc(plan, dec, planes, bitdepth):
    """Stage 1: inter prediction from dec's DPB stacks."""
    return motion_compensate_frame_dense(plan, planes, dec.dy, dec.dcb,
                                         dec.dcr, dec.slot_of, bitdepth)


def inter_residuals(plan, dec, planes, bitdepth):
    """Stage 2: the PCM paste, then the inter TUs' residuals with the
    clip, in batches by plane and size (backend.add_frame_residuals;
    explicit RDPCM on the host)."""
    meta, pool, pcm = tu_table(plan)
    _paste_pcm(plan, meta, pcm, planes)
    return add_frame_residuals(plan, planes, meta, pool, bitdepth)


def _paste_pcm(plan, meta, pcm, planes):
    """PCM blocks' raw samples into the planes (one index write per
    plane); each block holds its n*n luma samples, then its two chroma
    blocks."""
    rows = np.nonzero(meta[:, TU_CIDX] == -1)[0]
    if not rows.size:
        return
    sps = plan.sps
    dev = planes[0].device
    subw, subh = ((sps.SubWidthC, sps.SubHeightC) if sps.ChromaArrayType
                  else (0, 0))
    idx, val = [[], [], []], [[], [], []]
    for i in rows:
        x, y, n, off = (int(meta[i, TU_X]), int(meta[i, TU_Y]),
                        1 << int(meta[i, TU_LOG2]), int(meta[i, TU_COFF]))
        blocks = [(0, x, y, n, n)]
        if subw:
            blocks += [(c, x // subw, y // subh, n // subw, n // subh)
                       for c in (1, 2)]
        for c, bx, by, bw, bh in blocks:
            W = planes[c].shape[1]
            idx[c].append(((by + np.arange(bh))[:, None] * W
                           + bx + np.arange(bw)).ravel())
            val[c].append(pcm[off:off + bw * bh])
            off += bw * bh
    for c in range(3):
        if idx[c]:
            planes[c].view(-1)[to_tensor(np.concatenate(idx[c]), dev)] = \
                to_tensor(np.concatenate(val[c]).astype(np.int32), dev)


def intra_levels(plan, dec, planes, bitdepth):
    """Stage 3: intra TUs by wavefront levels."""
    return intra_reconstruct_device(plan, planes, bitdepth)


def loop_filters(plan, dec, planes, bitdepth):
    """Stage 4: deblocking, then SAO (K3)."""
    return apply_filters_fused(plan, planes)


STAGES = (("mc", dense_mc), ("residual", inter_residuals),
          ("intra", intra_levels), ("filters", loop_filters))


def new_planes(plan, device):
    """Zeroed [Y, Cb, Cr] int32 planes of the plan ((0, 0) chroma for
    monochrome)."""
    sps = plan.sps
    H, W = plan.H, plan.W
    Hc, Wc = ((H // sps.SubHeightC, W // sps.SubWidthC)
              if sps.ChromaArrayType else (0, 0))
    return [torch.zeros(s, dtype=torch.int32, device=device)
            for s in ((H, W), (Hc, Wc), (Hc, Wc))]


def reconstruct_frame_device(plan, dec, out_slot=None):
    """Reconstruct `plan` on dec's device: the stages of STAGES, the
    references read from dec's DPB stacks (every one resident). With
    out_slot, the result goes into the DPB stacks and tile tables at
    that slot (dec._do_insert). Returns the [Y, Cb, Cr] int32 planes."""
    with telemetry.span("hybrid"):
        planes = new_planes(plan, dec.device)
        for name, stage in STAGES:
            with telemetry.span(name):
                planes = stage(plan, dec, planes, dec.cfg.bitdepth)
        if out_slot is not None:
            with telemetry.span("insert"):
                dec._do_insert(planes, out_slot)
        return planes
