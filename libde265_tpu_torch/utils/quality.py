"""Quality metrics: SSD/SAD/MSE/PSNR/SSIM on tensors (counterpart of
libde265_tpu/utils/quality.py, itself the counterpart of libde265/
quality.{h,cc} + tools/yuv-distortion).

Plain functions on torch tensors, computed on the tensors' device; numpy
planes are accepted too (they are wrapped on the CPU). ssd, sad and mse
reduce in int64 and are exact; psnr, psnr_yuv and ssim work in float64.
The psnr of two equal planes is inf.
"""
import math

import numpy as np
import torch


def _t(a):
    if not isinstance(a, np.ndarray):
        return a
    # a plane over read-only bytes (np.frombuffer) is copied, not shared
    return torch.from_numpy(np.ascontiguousarray(a) if a.flags.writeable
                            else a.copy())


def _pair(a, b):
    a, b = _t(a), _t(b)
    return a, b.to(a.device)


def ssd(a, b):
    a, b = _pair(a, b)
    d = a.to(torch.int64) - b.to(torch.int64)
    return int((d * d).sum())


def sad(a, b):
    a, b = _pair(a, b)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().sum())


def mse(a, b):
    return ssd(a, b) / _t(a).numel()


def psnr(a, b, maxval=255):
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return 10.0 * math.log10(maxval * maxval / m)


def psnr_yuv(planes, ref_bytes, w, h):
    """PSNR of the three 8-bit 4:2:0 planes against one frame of raw YUV
    bytes (Y, then U, then V)."""
    cw, ch = w // 2, h // 2
    ry = np.frombuffer(ref_bytes[:w * h], np.uint8).reshape(h, w)
    ru = np.frombuffer(ref_bytes[w * h:w * h + cw * ch],
                       np.uint8).reshape(ch, cw)
    rv = np.frombuffer(ref_bytes[w * h + cw * ch:w * h * 3 // 2],
                       np.uint8).reshape(ch, cw)
    return [psnr(p, r) for p, r in zip(planes, (ry, ru, rv))]


def ssim(a, b, c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2, win=8):
    """Block SSIM (win x win tiles), mean over tiles."""
    a, b = _pair(a, b)
    a, b = a.to(torch.float64), b.to(torch.float64)
    h, w = a.shape
    h_t, w_t = h // win, w // win
    a = a[:h_t * win, :w_t * win].reshape(h_t, win, w_t, win)
    b = b[:h_t * win, :w_t * win].reshape(h_t, win, w_t, win)
    mu_a, mu_b = a.mean((1, 3)), b.mean((1, 3))
    var_a = a.var((1, 3), correction=0)
    var_b = b.var((1, 3), correction=0)
    cov = (a * b).mean((1, 3)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / \
        ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())
