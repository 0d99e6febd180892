"""In-loop filters of the hybrid device path: deblocking (V then H, luma
and chroma) through K6 and SAO through K3 (PyTorch).

Counterpart of libde265_tpu/ops/filters_fused_jax.py:54-101. The frame's
filter grids (device_plan.build_filter_grids) go up once; K6
(ops/kernels/deblock.deblock_frame, the frame program's deblocking)
derives the deblocking metadata from them, where the JAX path plans on
the host (deblock_jax.plan_luma_metadata / plan_chroma_metadata).
Deblocking reads the frame QP grid and the PPS chroma offsets only, so
TU-level chroma QP offsets leave it as the frame program has it, and
explicit-RDPCM (bypass) blocks are in the grids' `off`. SAO runs K3
(ops/kernels/sao_filter.sao_ctb) from the per-CTB SAO parameters, one
launch per plane, where the JAX path expands them into per-sample maps
(sao_jax.plan_sao_maps / sao_apply).
"""
from ..convert import plan_from_numpy
from ..device_plan import build_filter_grids, filter_cfg, sao_cfg
from .kernels.deblock import deblock_frame
from .kernels.sao_filter import sao_ctb


def apply_filters_fused(plan, planes):
    """Deblock and SAO the [Y, Cb, Cr] int32 device planes (on a CUDA
    device K6 deblocks contiguous planes in place). Returns the new
    plane list (monochrome chroma planes pass through)."""
    shs = plan.slice_headers or []
    # any-slice gate; per-CTB slice flags are honoured by the planners
    do_deblock = any(not sh.slice_deblocking_filter_disabled_flag
                     for sh in shs)
    do_sao = any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                 for sh in shs)
    if not do_deblock and not do_sao:
        return planes
    sps = plan.sps
    bd_y, bd_c = sps.BitDepthY, sps.BitDepthC
    g = plan_from_numpy(build_filter_grids(plan), planes[0].device)
    Y, Cb, Cr = planes
    if do_deblock:
        # K6 filters in place: the planes as they stand, or contiguous
        # copies
        Y, Cb, Cr = deblock_frame(*(P.contiguous() for P in planes), g,
                                  filter_cfg(plan), bd_y)
    if do_sao:
        scfg = sao_cfg(plan)
        Y = sao_ctb(Y.contiguous(), g, scfg, 0, 0, bd_y)
        if sps.ChromaArrayType:
            Cb = sao_ctb(Cb.contiguous(), g, scfg, 1, 0, bd_c)
            Cr = sao_ctb(Cr.contiguous(), g, scfg, 2, 0, bd_c)
    return [Y, Cb, Cr]
