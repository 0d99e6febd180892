"""K6: the in-loop deblocking filter of a picture's three planes
(csrc/deblock.cu).

`deblock_frame` launches the CUDA kernel twice for CUDA tensors (vertical
edges, then horizontal ones, each over Y, Cb and Cr, in place) and runs
`deblock_frame_plain` for CPU tensors; `deblock_frame.launches` counts
kernel launches. The plain version is the device planner
(filter_plan.plan_deblock_device) followed by the plain passes
(deblock.deblock_luma_pass / deblock_chroma_pass); the kernel derives the
planner's boundary strengths and decisions itself, per segment, from the
same grids.
"""
import ctypes

import torch

from ... import _build
from ..deblock import deblock_chroma_pass, deblock_luma_pass
from ..filter_plan import plan_deblock_device

# the grids K6 reads, in the kernel's order (csrc/deblock.cu G_*)
GRIDS = ("pm", "cbf", "tucb", "edgeall", "qp", "off", "pf", "mv", "poc",
         "sidx", "allow_v", "allow_h", "sh_disable", "sh_beta", "sh_tc")
# element type codes of csrc/deblock.cu's Grid: frame_grids leaves the
# 4x4 grids int32 (qp int8, motion int8 / int32), the strips and the
# hybrid path uint8 (motion int16)
_CODES = {torch.uint8: 0, torch.bool: 0, torch.int8: 1, torch.int16: 2,
          torch.int32: 3, torch.int64: 4}


class _Grid(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("code", ctypes.c_int),
                ("s", ctypes.c_int * 4)]


class _Plane(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("pitch", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("g", _Grid * len(GRIDS)), ("pl", _Plane * 3)] + [
        (n, ctypes.c_int) for n in (
            "gh", "gw", "nctby", "nctbx", "log2ctb", "chroma_fmt", "bd_y",
            "bd_c", "qpoff_cb", "qpoff_cr", "xoff", "vertical", "vec")]


def _subsampling(chroma_fmt):
    return (2 if chroma_fmt in (1, 2) else 1), (2 if chroma_fmt == 1 else 1)


def deblock_frame_plain(Y, Cb, Cr, t, fcfg, bitdepth, xoff=0):
    """Y, Cb, Cr: int32 planes of a frame, or of a halo-extended strip
    whose first column sits at global luma x = xoff; t: its grids
    (plan_deblock_device's keys); fcfg: (log2ctb, pcm_lf_disable,
    chroma_fmt, bd_y, bd_c, cb_qpoff, cr_qpoff, H, W). Luma filters at
    `bitdepth`, chroma at fcfg's bd_c; monochrome chroma passes through.
    Returns the deblocked (Y, Cb, Cr)."""
    lm, cm = plan_deblock_device(t, fcfg, xoff)
    subw, subh = _subsampling(fcfg[2])
    for vi, vertical in enumerate((True, False)):
        Y = deblock_luma_pass(Y, *lm[vi], vertical=vertical,
                              bitdepth=bitdepth)
        if cm is None:                               # monochrome
            continue
        # the maps are 4x4-luma-granular: chroma lines a map row by the
        # along-edge subsampling
        rep = 4 // (subh if vertical else subw)
        act, tc, p_off, q_off = cm[vi]
        Cb = deblock_chroma_pass(Cb, act[0], tc[0], p_off, q_off,
                                 vertical=vertical, bitdepth=fcfg[4],
                                 rep=rep)
        Cr = deblock_chroma_pass(Cr, act[1], tc[1], p_off, q_off,
                                 vertical=vertical, bitdepth=fcfg[4],
                                 rep=rep)
    return Y, Cb, Cr


def deblock_frame(Y, Cb, Cr, t, fcfg, bitdepth, xoff=0):
    """Kernel wrapper: same contract as deblock_frame_plain. On CUDA it
    checks the planes and grids as they arrive and launches the kernel
    twice, filtering the planes in place (it returns them); no other torch
    op runs."""
    if Y.device.type == "cpu":
        return deblock_frame_plain(Y, Cb, Cr, t, fcfg, bitdepth, xoff)
    if Y.device.type != "cuda":
        raise ValueError(f"deblock_frame: Y on {Y.device}, want a CUDA "
                         f"device")
    args = _args(Y, Cb, Cr, t, fcfg, bitdepth, xoff)
    fn = _build.kernel_fn("k6_deblock", [ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(Y.device).cuda_stream
    for vertical in (1, 0):
        args.vertical = vertical
        _build.check_launch("k6_deblock",
                            fn(ctypes.addressof(args), stream))
        deblock_frame.launches += 1
    return Y, Cb, Cr


def _args(Y, Cb, Cr, t, fcfg, bitdepth, xoff):
    """Raise on inputs the kernel does not take; return its _Args (with
    `vertical` left for the caller)."""
    (log2ctb, _, chroma_fmt, bd_y, bd_c, cb_qpoff, cr_qpoff, _, _) = fcfg
    dev = Y.device
    if not 8 <= bitdepth <= 16 or not 8 <= bd_c <= 16:
        raise ValueError(f"deblock_frame: bit depths {bitdepth}, {bd_c}")
    if chroma_fmt not in (0, 1, 2, 3):
        raise ValueError(f"deblock_frame: chroma format {chroma_fmt}")
    gh, gw = t["pm"].shape
    nctby, nctbx = t["sidx"].shape
    nsl = t["sh_disable"].shape[0]
    shapes = {"pf": (gh, gw, 2), "mv": (gh, gw, 2, 2), "poc": (gh, gw, 2),
              "allow_v": (nctby, nctbx), "allow_h": (nctby, nctbx),
              "sh_beta": (nsl,), "sh_tc": (nsl,)}
    a = _Args()
    for i, k in enumerate(GRIDS):
        g = t[k]
        if g.device != dev:
            raise ValueError(f"deblock_frame: grid {k} on {g.device}, Y on "
                             f"{dev}")
        if g.dtype not in _CODES:
            raise TypeError(f"deblock_frame: grid {k} is {g.dtype}, want "
                            f"one of {tuple(_CODES)}")
        want = shapes.get(k, (gh, gw) if k not in ("sidx", "sh_disable")
                          else tuple(g.shape))
        if tuple(g.shape) != want:
            raise ValueError(f"deblock_frame: grid {k} is "
                             f"{tuple(g.shape)}, want {want}")
        a.g[i].p = g.data_ptr()
        a.g[i].code = _CODES[g.dtype]
        for j, s in enumerate(g.stride()):
            a.g[i].s[j] = s
    subw, subh = _subsampling(chroma_fmt)
    planes = [(Y, (4 * gh, 4 * gw))]
    if chroma_fmt:
        planes += [(P, (4 * gh // subh, 4 * gw // subw)) for P in (Cb, Cr)]
    for i, (P, want) in enumerate(planes):
        if P.device != dev or P.dtype != torch.int32 or P.dim() != 2 \
                or P.stride(1) != 1 or tuple(P.shape) != want:
            raise ValueError(f"deblock_frame: plane {i} must be a {want} "
                             f"int32 plane with unit column stride on "
                             f"{dev}, got {P.dtype} {tuple(P.shape)} on "
                             f"{P.device}")
        a.pl[i].p = P.data_ptr()
        a.pl[i].h, a.pl[i].w = P.shape
        a.pl[i].pitch = P.stride(0)
    for k, v in (("gh", gh), ("gw", gw), ("nctby", nctby),
                 ("nctbx", nctbx), ("log2ctb", log2ctb),
                 ("chroma_fmt", chroma_fmt), ("bd_y", bitdepth),
                 ("bd_c", bd_c), ("qpoff_cb", cb_qpoff),
                 ("qpoff_cr", cr_qpoff), ("xoff", xoff)):
        setattr(a, k, int(v))
    a.vec = int(Y.data_ptr() % 16 == 0 and Y.stride(0) % 4 == 0)
    return a


deblock_frame.launches = 0
