"""bench_gop: GOP-parallel decode scaling with spawned workers
(counterpart of the JAX package's tools/bench_gop.py).

    python -m libde265_tpu_torch.tools.bench_gop [--workers 1,2,4,8]
        [--stream gop1080p] [--manifest manifest_big.json]
        [--device cuda|cpu]

Decodes the multi-IRAP stream (tests/data/gop1080p.bin: 16 IDR-delimited
1080p GOPs) through parallel/gop_parallel.decode_gop_parallel on its
worker route (backend="workers", one spawned process per worker count
entry, each decoding whole segments with decode_stream_native on
--device), and holds every run's frames to the manifest's per-plane
MD5s (a mismatch raises). Prints a line per worker count (frames/s and
the scaling efficiency against one worker, fps(n) / (fps(1) * min(n,
cores))) and one JSON line. The JAX tool's workers reconstruct with
numpy on the host; these decode on the device, all of them on the one
card by default, so the efficiency measures how far the workers' host
work (parse, pack, start-up) overlaps on it.
"""
import argparse
import hashlib
import json
import os
import sys
import time

from .bench import DATA, device_name


def frame_md5s(yuv, w, h):
    """Per-plane MD5s of one 8-bit 4:2:0 frame's planar bytes."""
    ysz, csz = w * h, (w // 2) * (h // 2)
    return [hashlib.md5(yuv[:ysz]).hexdigest(),
            hashlib.md5(yuv[ysz:ysz + csz]).hexdigest(),
            hashlib.md5(yuv[ysz + csz:]).hexdigest()]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_gop")
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--stream", default="gop1080p")
    ap.add_argument("--manifest", default="manifest_big.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve
    from ..parallel.gop_parallel import decode_gop_parallel, split_gops
    dev = resolve(args.device)
    with open(os.path.join(DATA, args.manifest)) as f:
        man = json.load(f)[args.stream]
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        stream = f.read()
    w, h, nf = man["w"], man["h"], man["frames"]
    ngops = len(split_gops(stream))
    print(f"# {args.stream}: {nf} frames {w}x{h}, {ngops} GOPs", flush=True)
    ncpu = os.cpu_count()
    results = []
    base_fps = None
    for nw in (int(x) for x in args.workers.split(",")):
        st = {}
        t0 = time.perf_counter()
        frames = decode_gop_parallel(stream, workers=nw, backend="workers",
                                     devices=[str(dev)], stats=st)
        dt = time.perf_counter() - t0
        if len(frames) != nf:
            raise RuntimeError(f"workers={nw}: {len(frames)} frames, the "
                               f"manifest has {nf}")
        for i, (_poc, yuv) in enumerate(frames):
            want = [man["md5"][i][k] for k in ("y", "u", "v")]
            if frame_md5s(yuv, w, h) != want:
                raise RuntimeError(f"workers={nw} frame {i}: MD5 differs "
                                   f"from {args.manifest}")
        fps = nf / dt
        base_fps = base_fps or fps
        eff = fps / (base_fps * min(nw, ncpu))
        results.append({"workers": nw, "fps": fps, "efficiency": eff,
                        "oversubscribed": nw > ncpu,
                        "launches": st["launches"]})
        print(f"workers={nw}: {fps:.2f} fps, efficiency {eff:.1%}"
              f"{' (oversubscribed: %d cores)' % ncpu if nw > ncpu else ''}",
              flush=True)
    print(json.dumps({"stream": args.stream, "gops": ngops, "cores": ncpu,
                      "device": device_name(dev), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
