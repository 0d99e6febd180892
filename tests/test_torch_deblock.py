"""K6's wrapper (libde265_tpu_torch/ops/kernels/deblock.py) on CPU
tensors: deblock_frame is the frame program's old deblocking stage (the
device planner, then the plain luma and chroma passes) on every frame of
small vectors, launches nothing, and refuses inputs the kernel does not
take. The kernel itself runs on the card only (tests/test_torch_cuda.py,
marker `cuda`)."""
import os

import pytest
import torch

from test_torch_packing import STREAMS

DATA = os.path.join(os.path.dirname(__file__), "data")


def _old_stage(Y, Cb, Cr, t, fcfg, bitdepth):
    """The frame program's deblocking stage as it was before K6."""
    from libde265_tpu_torch.ops.deblock import (deblock_chroma_pass,
                                                deblock_luma_pass)
    from libde265_tpu_torch.ops.filter_plan import plan_deblock_device
    fmt = fcfg[2]
    subw, subh = (2 if fmt in (1, 2) else 1), (2 if fmt == 1 else 1)
    lm, cmeta = plan_deblock_device(t, fcfg)
    for vi, vertical in enumerate((True, False)):
        Y = deblock_luma_pass(Y, *lm[vi], vertical=vertical,
                              bitdepth=bitdepth)
        if cmeta is None:
            continue
        rep = 4 // (subh if vertical else subw)
        act, tc_map, p_off, q_off = cmeta[vi]
        Cb = deblock_chroma_pass(Cb, act[0], tc_map[0], p_off, q_off,
                                 vertical=vertical, bitdepth=bitdepth,
                                 rep=rep)
        Cr = deblock_chroma_pass(Cr, act[1], tc_map[1], p_off, q_off,
                                 vertical=vertical, bitdepth=bitdepth,
                                 rep=rep)
    return Y, Cb, Cr


@pytest.mark.parametrize("name", STREAMS)
def test_deblock_frame_cpu_is_old_stage(name, monkeypatch):
    """Every frame of the vector through the frame program on the CPU:
    deblock_frame's output equals the old stage on copies of its inputs,
    the telemetry span "deblock" counts no launch, and
    deblock_frame.launches stays 0."""
    import libde265_tpu_torch.frame_program as FP
    from libde265_tpu_torch import telemetry
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels import deblock as k
    real, calls = k.deblock_frame, []

    def rec(Y, Cb, Cr, t, fcfg, bitdepth, xoff=0):
        ins = [P.clone() for P in (Y, Cb, Cr)]
        out = real(Y, Cb, Cr, t, fcfg, bitdepth, xoff)
        calls.append((out, _old_stage(*ins, t, fcfg, bitdepth), xoff))
        return out
    rec.launches = 0
    monkeypatch.setattr(FP, "deblock_frame", rec)
    n = k.deblock_frame.launches
    telemetry.clear()
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        pics = decode_stream_native(f.read(), device="cpu")
    assert len(calls) == len(pics) and k.deblock_frame.launches == n
    assert telemetry.totals()["deblock"][2] == 0
    for i, (got, want, xoff) in enumerate(calls):
        assert xoff == 0
        for ci, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (name, i, ci)


def _tiny_inputs():
    """A 16x16 4:2:0 frame's planes and grids (zeros), with its fcfg."""
    z = torch.zeros
    g = {k: z((4, 4), dtype=torch.int32) for k in
         ("pm", "cbf", "tucb", "edgeall", "qp", "off")}
    g.update(pf=z((4, 4, 2), dtype=torch.int32),
             mv=z((4, 4, 2, 2), dtype=torch.int32),
             poc=z((4, 4, 2), dtype=torch.int32),
             sidx=z((1, 1), dtype=torch.int32),
             allow_v=z((1, 1), dtype=torch.bool),
             allow_h=z((1, 1), dtype=torch.bool),
             sh_disable=z(1, dtype=torch.int32),
             sh_beta=z(1, dtype=torch.int32),
             sh_tc=z(1, dtype=torch.int32))
    planes = [z((16, 16), dtype=torch.int32),
              z((8, 8), dtype=torch.int32), z((8, 8), dtype=torch.int32)]
    return planes, g, (4, False, 1, 8, 8, 0, 0, 16, 16)


@pytest.mark.parametrize("bad", ["plane_dtype", "plane_shape",
                                 "plane_stride", "grid_dtype",
                                 "grid_shape", "bitdepth"])
def test_deblock_frame_refuses(bad):
    """The checks the CUDA route makes before its launch (ops/kernels/
    deblock._args, run here on CPU tensors): a plane that is not int32,
    not the grids' size or without unit column stride, a grid of a
    floating type or of the wrong shape, a bit depth outside 8..16."""
    from libde265_tpu_torch.ops.kernels.deblock import _args
    planes, g, fcfg = _tiny_inputs()
    bd = 8
    if bad == "plane_dtype":
        planes[0] = planes[0].to(torch.int16)
    elif bad == "plane_shape":
        planes[1] = torch.zeros((8, 16), dtype=torch.int32)
    elif bad == "plane_stride":
        planes[2] = torch.zeros((8, 16), dtype=torch.int32)[:, ::2]
    elif bad == "grid_dtype":
        g["qp"] = g["qp"].float()
    elif bad == "grid_shape":
        g["mv"] = torch.zeros((4, 4, 2), dtype=torch.int32)
    else:
        bd = 7
    with pytest.raises((TypeError, ValueError)):
        _args(*planes, g, fcfg, bd, 0)
    planes, g, fcfg = _tiny_inputs()
    a = _args(*planes, g, fcfg, 8, 0)       # the untouched inputs pass
    assert (a.gh, a.gw, a.nctby, a.nctbx, a.chroma_fmt) == (4, 4, 1, 1, 1)
