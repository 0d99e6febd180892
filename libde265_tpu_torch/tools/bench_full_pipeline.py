"""bench_full_pipeline: a synthetic 4K decode chain on the device, MC,
residuals, deblocking and SAO, frame after frame (counterpart of the JAX
package's tools/bench_full_pipeline.py, on the port's ops).

    python -m libde265_tpu_torch.tools.bench_full_pipeline [--iters 20]
        [--height 2176] [--width 3840] [--device cuda|cpu]

Inputs are seeded with np.random.RandomState(0) as in the JAX tool: one
motion vector pair per 4x4 block (every qpel phase, 30% bi-predicted,
two references), a TU mix of 40,000 4x4, 16,000 8x8, 5,000 16x16 and
800 32x32 residual blocks at QP 32 (scaled to the frame's area; each
TU at a distinct position, so the scatter has one writer per sample),
deblocking metadata (random boundary strengths at QP 32) and per-CTB
SAO parameters (random band and edge types, offsets -2..2). Each
iteration:
1. dense MC (ops/inter_dense.mc_dense) from the previous two
   iterations' frames, so iterations depend on each other in series;
2. the residual batches (ops/transform.residual_batch), scattered and
   added to the luma prediction with the clip;
3. deblocking (ops/deblock.py), vertical then horizontal edges, luma and
   both chroma planes;
4. SAO through K3 (ops/kernels/sao_filter.sao_ctb), all three planes;
the luma result is perturbed by the iteration's parity. One untimed
iteration, then `iters` timed ones (CUDA events on the card); ends with
an int64 checksum of the last frame and one JSON line.
"""
import argparse
import json
import sys

import numpy as np

from .bench import BASELINE_FPS, _seconds, device_name

TU_MIX = [(2, 40000), (3, 16000), (4, 5000), (5, 800)]   # (log2, TUs)


def inputs(H, W, dev, seed=0):
    """The seeded inputs of the chain on `dev`."""
    import torch
    rng = np.random.RandomState(seed)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    N = (H // 4) * (W // 4)
    mc = dict(mv=T(rng.randint(-128, 128, (N, 2, 2)).astype(np.int32)),
              slot=T(rng.randint(0, 2, (N, 2)).astype(np.int32)),
              pf=T(np.stack([np.ones(N, np.int32),
                             (rng.rand(N) < 0.3).astype(np.int32)], 1)))
    scale = H * W / (2176 * 3840)
    tus = []
    for log2, n_tu in TU_MIX:
        n = 1 << log2
        nslots = (H >> log2) * (W >> log2)
        k = min(nslots, max(1, int(n_tu * scale)))
        tus.append((log2,
                    T(rng.randint(-128, 128, (k, n, n)).astype(np.int32)),
                    T(np.full((k,), 32, np.int32)),
                    T(rng.choice(nslots, k, replace=False).astype(np.int64))))

    def dbmeta(n_s, n_e):
        z = np.zeros((n_s, n_e), np.int32)
        return (T(rng.randint(0, 3, (n_s, n_e)).astype(np.int32)),
                T(np.full((n_s, n_e), 32, np.int32)), T(z), T(z),
                T(z.astype(bool)), T(z.astype(bool)))

    def cbmeta(n_s, n_e):
        z = np.zeros((n_s, n_e), bool)
        return (T(rng.randint(0, 2, (2, n_s, n_e)).astype(bool)),
                T(np.full((2, n_s, n_e), 4, np.int32)), T(z), T(z))

    # segments of 4 luma lines along each edge, chroma's too (a row of
    # the chroma maps covers 2 chroma lines: deblock_chroma_pass's rep)
    dbk = dict(lv=dbmeta(H // 4, W // 8 - 1), lh=dbmeta(W // 4, H // 8 - 1),
               cv=cbmeta(H // 4, W // 16 - 1), ch=cbmeta(W // 4, H // 16 - 1))
    log2ctb = 6
    ny, nx = -(-H >> log2ctb), -(-W >> log2ctb)
    sao = dict(
        sao_type=T(rng.randint(0, 3, (ny, nx, 3)).astype(np.uint8)),
        sao_eo=T(rng.randint(0, 4, (ny, nx, 3)).astype(np.uint8)),
        sao_band=T(rng.randint(0, 29, (ny, nx, 3)).astype(np.uint8)),
        sao_off=T(rng.randint(-2, 3, (ny, nx, 3, 4)).astype(np.int16)),
        sidx=T(np.zeros((ny, nx), np.int32)),
        sh_sao_luma=T(np.ones(16, np.int32)),
        sh_sao_chroma=T(np.ones(16, np.int32)),
        pair_ok=T(np.ones((4, ny, nx), bool)),
        off=T(np.zeros((H // 4, W // 4), np.int32)))
    scfg = (log2ctb, 1, H, W, 2, 2)
    Y0 = T(rng.randint(0, 255, (H, W)).astype(np.int32))
    C0 = T(rng.randint(0, 255, (H // 2, W // 2)).astype(np.int32))
    return mc, tus, dbk, sao, scfg, Y0, C0


def frame_step(cur, prev, mc, tus, dbk, sao, scfg):
    """One frame of the chain from the current and previous frames'
    (Y, Cb, Cr) int32 planes; returns the new frame's."""
    import torch
    from ..ops.deblock import deblock_chroma_pass, deblock_luma_pass
    from ..ops.inter_dense import mc_dense
    from ..ops.kernels.sao_filter import sao_ctb
    from ..ops.transform import residual_batch
    H, W = cur[0].shape
    refs = [torch.stack([a, b]).to(torch.int16) for a, b in zip(cur, prev)]
    Y, Cb, Cr = mc_dense(*refs, mc["mv"], mc["slot"], mc["pf"], None, None,
                         8)
    acc = torch.zeros((H, W), dtype=torch.int32, device=Y.device)
    for log2, coeffs, qp, slots in tus:
        n = 1 << log2
        res = residual_batch(coeffs, qp, log2, False, 8)
        table = acc.new_zeros(((H >> log2) * (W >> log2), n * n))
        table[slots] = res.reshape(-1, n * n).to(torch.int32)
        acc += table.reshape(H >> log2, W >> log2, n, n) \
            .permute(0, 2, 1, 3).reshape(H, W)
    Y = torch.clamp(Y + acc, 0, 255)
    Y = deblock_luma_pass(Y, *dbk["lv"], vertical=True, bitdepth=8)
    Y = deblock_luma_pass(Y, *dbk["lh"], vertical=False, bitdepth=8)
    for key, vertical in (("cv", True), ("ch", False)):
        act, tc, po, qo = dbk[key]
        Cb = deblock_chroma_pass(Cb, act[0], tc[0], po, qo,
                                 vertical=vertical, bitdepth=8)
        Cr = deblock_chroma_pass(Cr, act[1], tc[1], po, qo,
                                 vertical=vertical, bitdepth=8)
    return [sao_ctb(P.contiguous(), sao, scfg, ci, bitdepth=8)
            for ci, P in enumerate((Y, Cb, Cr))]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_full_pipeline")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--height", type=int, default=2176)   # 4K, CTB-padded
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch
    from ..device import resolve
    dev = resolve(args.device)
    mc, tus, dbk, sao, scfg, Y0, C0 = inputs(args.height, args.width, dev)
    state = {"i": 0, "cur": [Y0, C0, C0.clone()],
             "prev": [Y0, C0, C0.clone()]}

    def step():
        new = frame_step(state["cur"], state["prev"], mc, tus, dbk, sao,
                         scfg)
        new[0] = new[0] + (state["i"] & 1)   # no two iterations alike
        state["i"] += 1
        state["prev"], state["cur"] = state["cur"], new

    step()                                                  # untimed
    s = _seconds(dev, step, args.iters)
    chk = int(sum(p.to(torch.int64).sum() for p in state["cur"]))
    fps = 1.0 / s
    print(json.dumps({
        "metric": f"{dev.type}_4k_decode_pipeline_fps",
        "value": fps,
        "unit": f"frames/s (device MC + residual + deblock + SAO chain, "
                f"{args.width}x{args.height}, iterations in series)",
        "vs_baseline": fps / BASELINE_FPS,
        "ms_per_frame": s * 1e3, "iters": args.iters, "checksum": chk,
        "device": device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
