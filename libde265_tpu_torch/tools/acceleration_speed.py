"""Check and time the port's device ops against their scalar references
on random blocks (counterpart of the JAX package's
tools/acceleration_speed.py and of libde265's acceleration-speed).

    python -m libde265_tpu_torch.tools.acceleration_speed [--check] \
        [--time] [--kernel all|transform|mc] [--device cuda|cpu]

transform: ops/transform.residual_batch (dequant + inverse DCT) on 2048
    random coefficient blocks of each size 4x4 to 32x32, every 97th block
    held to ops/transform_ref.scale_and_inv_transform;
mc: ops/inter_dense.mc_luma_dense (the per-4x4-block luma MC of the
    hybrid device path) predicting 256 PUs of each size 8x8 to 64x64 from
    one 512x512 reference at random integer positions and quarter-pel
    phases, every 37th PU held to ops/inter_ref.mc_luma with the default
    uni-prediction weighting.

The blocks come from numpy's RandomState(0), drawn in the JAX tool's
order, so both tools check the same blocks. --time adds one line per op
and size: milliseconds a call, between CUDA events on the card (host
clock on the CPU). The checks always run (--check is on by default).
"""
import argparse
import sys
import time

import numpy as np
import torch

PU_SIZES = ((8, 8), (16, 16), (32, 32), (64, 64))


def _ms(fn, device, iters=20):
    """Milliseconds a call of fn() after one warm-up call, and how they
    were taken."""
    fn()
    if device.type == "cuda":
        from ..profile_frames import cuda_ms
        torch.cuda.synchronize(device)
        return cuda_ms(fn, iters), "CUDA events"
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3, "host clock"


def check_transform(args, rng, device):
    from ..ops import transform_ref
    from ..ops.transform import residual_batch
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        N = 2048
        coeffs = rng.randint(-3000, 3000, (N, n, n)).astype(np.int32)
        qps = rng.randint(0, 52, N).astype(np.int32)
        ct = torch.from_numpy(coeffs).to(device)
        qt = torch.from_numpy(qps).to(device)
        got = residual_batch(ct, qt, log2, False, 8).cpu().numpy()
        if args.check:
            for i in range(0, N, 97):
                ref = transform_ref.scale_and_inv_transform(
                    coeffs[i], int(qps[i]), log2, False, False, False)
                if not np.array_equal(got[i], ref):
                    raise AssertionError(f"idct{n} mismatch @ {i}")
        print(f"transform {n}x{n}: OK")
        if args.time:
            ms, how = _ms(lambda: residual_batch(ct, qt, log2, False, 8),
                          device)
            print(f"  idct{n}x{n} x{N}: {ms:.4f} ms a call ({how})")


def pu_motion(xs, ys, fx, fy, w, h, size):
    """The 4x4 motion field (n_by * n_bx, 2, 2) int32 of size x size
    frames that hold the PUs of one batch side by side, and where each
    PU is: frame k, top-left (px, py). PU i predicts its w x h block from
    the integer reference position (xs[i], ys[i]) at phases (fx[i],
    fy[i])."""
    per_row = size // w
    cells = per_row * (size // h)
    nb = size // 4
    nf = -(-len(xs) // cells)
    mv = np.zeros((nf, nb, nb, 2, 2), np.int32)
    where = []
    for i in range(len(xs)):
        k, c = divmod(i, cells)
        px, py = (c % per_row) * w, (c // per_row) * h
        mv[k, py // 4:(py + h) // 4, px // 4:(px + w) // 4, 0] = (
            (int(xs[i]) - px) * 4 + int(fx[i]),
            (int(ys[i]) - py) * 4 + int(fy[i]))
        where.append((k, px, py))
    return mv.reshape(nf, nb * nb, 2, 2), where


def check_mc(args, rng, device):
    from ..ops import inter_ref
    from ..ops.inter_dense import mc_luma_dense
    size = 512
    ref_plane = rng.randint(0, 255, (size, size)).astype(np.int32)
    refs = torch.from_numpy(ref_plane.astype(np.int16))[None].to(device)
    nblk = (size // 4) ** 2
    slot = torch.zeros((nblk, 2), dtype=torch.int32, device=device)
    pf = torch.zeros((nblk, 2), dtype=torch.int32, device=device)
    pf[:, 0] = 1
    for (w, h) in PU_SIZES:
        N = 256
        xs = rng.randint(-8, 480, N).astype(np.int32)
        ys = rng.randint(-8, 480, N).astype(np.int32)
        fx = rng.randint(0, 4, N).astype(np.int32)
        fy = rng.randint(0, 4, N).astype(np.int32)
        mv, where = pu_motion(xs, ys, fx, fy, w, h, size)
        mvs = [torch.from_numpy(m).to(device) for m in mv]
        frames = [mc_luma_dense(refs, m, slot, pf, None, None, bi=False)
                  .cpu().numpy() for m in mvs]
        if args.check:
            for i in range(0, N, 37):
                k, px, py = where[i]
                pred = inter_ref.mc_luma(ref_plane, int(xs[i]), int(ys[i]),
                                         w, h, (int(fx[i]), int(fy[i])))
                want = np.clip((pred + 32) >> 6, 0, 255)   # 8-bit uni
                if not np.array_equal(frames[k][py:py + h, px:px + w],
                                      want):
                    raise AssertionError(f"qpel {w}x{h} @ {i}")
        print(f"mc_luma {w}x{h}: OK")
        if args.time:
            ms, how = _ms(lambda: mc_luma_dense(refs, mvs[0], slot, pf,
                                                None, None, bi=False),
                          device)
            print(f"  mc_luma_dense {size}x{size} frame of {w}x{h} PUs: "
                  f"{ms:.4f} ms a call ({how})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="acceleration_speed")
    ap.add_argument("--check", action="store_true", default=True)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--kernel", default="all")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve
    device = resolve(args.device)
    rng = np.random.RandomState(0)
    if args.kernel in ("all", "transform"):
        check_transform(args, rng, device)
    if args.kernel in ("all", "mc"):
        check_mc(args, rng, device)
    print("all kernels verified against scalar reference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
