"""Host and device time of one 4K P frame through the frame program, for
comparing two checkouts of the port on one CUDA card.

    python3 libde265_tpu_torch/time_frames.py [ROOT] [TAG]

ROOT is the checkout whose libde265_tpu_torch is timed (default: the one
holding this file); the script is run by path so that ROOT's package is
the one imported. It decodes the first P frame of tests/data/ld4k_light
through profile_frames.frame_calls, then three times: CUDA-event
milliseconds per frame over 20 frames, the host's enqueue milliseconds
per frame over 20 frames (no synchronisation inside) and the median of
10 frames each synchronised. Lines are tagged with TAG.

    python3 libde265_tpu_torch/time_frames.py --k4 [ROOT] [TAG]

times ROOT's K4 wrapper `intra_scan` on the whole ld4k_light IDR instead,
each plane group on seeded random planes: CUDA-event milliseconds per
call over 10 calls, three times, and a digest of the planes after one
call (equal digests: the two checkouts computed the same planes).
"""
import hashlib
import os
import sys
import time


def time_k4(plans, dev, tag):
    from dataclasses import replace

    import numpy as np
    import torch
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    from libde265_tpu_torch.profile_frames import cuda_ms
    cfg = replace(stream_cfg(plans, plans[0].sps), skip_mc=True)
    t = plan_from_numpy(pack_frame(plans[0], cfg, {}), dev)
    rng = np.random.RandomState(2160)
    dims = [(cfg.H, cfg.W)] + [(cfg.H // 2, cfg.W // 2)] * 2
    for idx, kw in scan_groups(t, cfg):
        got = [torch.as_tensor(rng.randint(0, 256, dims[i]),
                               dtype=torch.int32, device=dev) for i in idx]
        intra_scan(got, **kw)
        digest = hashlib.sha256(b"".join(
            p.cpu().numpy().tobytes() for p in got)).hexdigest()[:16]
        for rep in range(3):
            ms = cuda_ms(lambda: intra_scan(got, **kw), 10)
            print(f"{tag} K4 planes {idx} rep {rep}: {ms:.4f} ms a call; "
                  f"planes sha256 {digest}", flush=True)


def main(argv):
    k4 = argv[:1] == ["--k4"]
    argv = argv[1:] if k4 else argv
    root = os.path.abspath(argv[0]) if argv else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = argv[1] if len(argv) > 1 else root
    sys.path.insert(0, root)
    import torch
    from libde265_tpu_torch import _build
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.profile_frames import cuda_ms, frame_calls
    dev = torch.device("cuda")
    _build.ensure_frontend()
    with open(os.path.join(root, "tests", "data", "ld4k_light.bin"),
              "rb") as f:
        plans = _parse(f.read())
    if k4:
        return time_k4(plans, dev, tag)
    (_, idr, _), (_, pframe, _) = frame_calls(plans, dev)
    idr()
    pframe()
    torch.cuda.synchronize()
    for rep in range(3):
        ev = cuda_ms(pframe, 20)
        t0 = time.perf_counter()
        for _ in range(20):
            pframe()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        synced = []
        for _ in range(10):
            a = time.perf_counter()
            pframe()
            torch.cuda.synchronize()
            synced.append(time.perf_counter() - a)
        print(f"{tag} rep {rep}: events {ev:.3f} ms/frame; host enqueue "
              f"{1e3 * (t1 - t0) / 20:.3f} ms/frame; synchronised median "
              f"{1e3 * sorted(synced)[5]:.3f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
