"""K3: SAO of one plane from the per-CTB SAO parameters
(csrc/sao_filter.cu).

Replaces libde265_tpu/ops/pallas/sao_filter.py:sao_pallas and the
planner that fed it (the per-sample maps of ops/filter_plan.py). `sao_ctb`
launches the CUDA kernel for CUDA tensors and runs `sao_ctb_plain`, the
same function in plain PyTorch, for CPU tensors; `sao_ctb.launches`
counts kernel launches. The plain version is the planner's compact maps
(filter_plan.plan_sao_compact) applied by `sao_filter_plain`.
"""
import ctypes

import torch

from ... import _build
from ..filter_plan import plan_sao_compact

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 16 + [ctypes.c_void_p]

# the grids K3 reads, with the dtypes frame_grids / plan_from_numpy give
# them ("off" arrives bit-unpacked as int32 on the main path and as uint8
# in the strips)
_GRID_DTYPES = {"sao_type": (torch.uint8,), "sao_eo": (torch.uint8,),
                "sao_band": (torch.uint8,), "sao_off": (torch.int16,),
                "sidx": (torch.int32,), "sh_sao_luma": (torch.int32,),
                "sh_sao_chroma": (torch.int32,), "pair_ok": (torch.bool,),
                "off": (torch.uint8, torch.int32)}


def sao_filter_plain(x, mode, aux, offs, bitdepth=8):
    """x: (H, W) int32 plane; mode/aux: (H, W) int8; offs: (4, H, W) int8
    (ops/filter_plan.plan_sao_compact). Returns the filtered plane."""
    H, W = x.shape
    maxv = (1 << bitdepth) - 1
    # neighbours with edge-clamped coordinates (the planner zeroes mode
    # wherever a neighbour would be outside the picture)
    xp = torch.cat([x[:1], x, x[-1:]], dim=0)
    xp = torch.cat([xp[:, :1], xp, xp[:, -1:]], dim=1)

    def nb(dy, dx):
        return xp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    a_ = aux.to(torch.int32)
    md = mode.to(torch.int32)
    o = [offs[k].to(torch.int32) for k in range(4)]
    a = torch.where(a_ == 0, nb(0, -1), torch.where(
        a_ == 1, nb(-1, 0), torch.where(a_ == 2, nb(-1, -1), nb(-1, 1))))
    b = torch.where(a_ == 0, nb(0, 1), torch.where(
        a_ == 1, nb(1, 0), torch.where(a_ == 2, nb(1, 1), nb(1, -1))))
    sgn = torch.sign(x - a) + torch.sign(x - b)
    zero = torch.zeros_like(x)
    de = torch.where(sgn == -2, o[0], torch.where(
        sgn == -1, o[1], torch.where(sgn == 1, o[2], torch.where(
            sgn == 2, o[3], zero))))
    k = ((x >> (bitdepth - 5)) - a_) & 31
    db = torch.where(k == 0, o[0], torch.where(
        k == 1, o[1], torch.where(k == 2, o[2], torch.where(
            k == 3, o[3], zero))))
    delta = torch.where(md == 1, db, torch.where(md == 2, de, zero))
    return torch.clamp(x + delta, 0, maxv)


def sao_ctb_plain(x, g, scfg, cidx, xoff=0, bitdepth=8):
    """x: the deblocked (H, W) int32 plane `cidx` of a frame, or of a
    halo-extended strip whose first column sits at global luma x = xoff;
    g: its grids (sao_type/eo/band, sao_off, sidx, sh_sao_luma/chroma,
    pair_ok, off); scfg: ProgramCfg.scfg. Returns the SAO-filtered
    plane."""
    return sao_filter_plain(x, *plan_sao_compact(g, scfg, cidx, xoff),
                            bitdepth)


def sao_ctb(x, g, scfg, cidx, xoff=0, bitdepth=8):
    """Kernel wrapper: same contract as sao_ctb_plain. On CUDA it checks
    the grids as they arrive and launches one kernel; its only torch op is
    the output's torch.empty."""
    if x.device.type == "cpu":
        return sao_ctb_plain(x, g, scfg, cidx, xoff, bitdepth)
    if x.device.type != "cuda":
        raise ValueError(f"sao_ctb: x on {x.device}, want a CUDA device")
    geo = _check(x, g, scfg, cidx, xoff, bitdepth)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _launch(out, x, g, cidx, bitdepth, geo)
    sao_ctb.launches += 1
    return out


def _check(x, g, scfg, cidx, xoff, bitdepth):
    """Raise on inputs the kernel does not take; return the launch
    geometry (gx0, ctb, ctbv, fxs, fys, wpic)."""
    if x.dtype != torch.int32 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError("sao_ctb: x must be an (H, W) int32 plane with "
                         "unit column stride")
    for k, dts in _GRID_DTYPES.items():
        a = g[k]
        if a.device != x.device:
            raise ValueError(f"sao_ctb: grid {k} on {a.device}, x on "
                             f"{x.device}")
        if a.dtype not in dts:
            raise TypeError(f"sao_ctb: grid {k} is {a.dtype}, want one of "
                            f"{dts}")
        if k != "off" and not a.is_contiguous():
            raise ValueError(f"sao_ctb: grid {k} must be contiguous")
    log2ctb, _, H, W, subw, subh = scfg
    if not 0 <= cidx <= 2 or not 8 <= bitdepth <= 16:
        raise ValueError(f"sao_ctb: plane {cidx}, bitdepth {bitdepth}")
    sub, subv = (1, 1) if cidx == 0 else (subw, subh)
    nctby, nctbx = g["sidx"].shape
    og = g["off"]
    if og.dim() != 2 or og.stride(1) != 1:
        raise ValueError("sao_ctb: the off grid must be 2-D with unit "
                         "column stride")
    Hs, Ws = x.shape
    if Hs != H // subv or Ws != og.shape[1] * 4 // sub \
            or og.shape[0] * (4 // subv) < Hs:
        raise ValueError(f"sao_ctb: plane {tuple(x.shape)} does not match "
                         f"the off grid {tuple(og.shape)} and H = {H}")
    shapes = {"sao_type": (nctby, nctbx, 3), "sao_eo": (nctby, nctbx, 3),
              "sao_band": (nctby, nctbx, 3),
              "sao_off": (nctby, nctbx, 3, 4),
              "pair_ok": (4, nctby, nctbx)}
    for k, shp in shapes.items():
        if tuple(g[k].shape) != shp:
            raise ValueError(f"sao_ctb: grid {k} is {tuple(g[k].shape)}, "
                             f"want {shp}")
    ctb, ctbv = (1 << log2ctb) // sub, (1 << log2ctb) // subv
    return (xoff // sub, ctb, ctbv, (4 // sub).bit_length() - 1,
            (4 // subv).bit_length() - 1, W // sub)


def _launch(out, x, g, cidx, bitdepth, geo):
    gx0, ctb, ctbv, fxs, fys, wpic = geo
    H, W = x.shape
    og = g["off"]
    nctby, nctbx = g["sidx"].shape
    en = g["sh_sao_luma"] if cidx == 0 else g["sh_sao_chroma"]
    vec = int(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0
              and W % 4 == 0)
    fn = _build.kernel_fn("k3_sao_ctb", _ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(out.data_ptr(), x.data_ptr(), og.data_ptr(),
             *(g[k].data_ptr() for k in ("sao_type", "sao_eo", "sao_band",
                                         "sao_off", "sidx")),
             en.data_ptr(), g["pair_ok"].data_ptr(), H, W, x.stride(0),
             og.stride(0), og.element_size(), gx0, ctb, ctbv, fxs, fys, wpic,
             nctby, nctbx, cidx, bitdepth, vec, stream)
    _build.check_launch("k3_sao_ctb", err)


sao_ctb.launches = 0
