"""bench_frontend: native front-end throughput, per stream and per
FE_THREADS count (counterpart of the JAX package's
tools/bench_frontend.py, through the port's native_frontend.py).

    python -m libde265_tpu_torch.tools.bench_frontend [OUT]
        [--streams a,b,...] [--reps 3]

For each stream of tests/data and FE_THREADS 1 and 4: the best of `reps`
runs of the native parse (fe_push_stream: CABAC pool and motion replay)
and of the plan extraction (extract_all), in frames/s. Writes one JSON
line per (stream, threads) to OUT, or to stdout without it (never to
the repository's FRONTEND.json, the JAX tool's record). Host work only:
no device is used.
"""
import argparse
import json
import os
import sys
import time

from .bench import DATA

# the JAX tool's streams: heavy self-generated ones and the light ones
# at the reference's broadcast rates
STREAMS = ("ld_1080p_wpp", "gop1080p", "ld4k_light", "ld4k",
           "ld720p_light", "ld1080p_light")


def bench(stream, threads, reps=3):
    """One row: frames, plans, geometry, the stream's Mbit/s at 30 fps
    and the best parse, extraction and combined rates."""
    from ..api import _param_sets
    from ..native_frontend import NativeFrontend
    with open(os.path.join(DATA, stream + ".bin"), "rb") as f:
        data = f.read()
    spss, ppss = _param_sets(data)
    old = os.environ.get("FE_THREADS")
    os.environ["FE_THREADS"] = str(threads)
    best_push = best_ext = 0.0
    n = nplans = 0
    try:
        for _ in range(reps):
            fe = NativeFrontend()
            t0 = time.perf_counter()
            n = fe.lib.fe_push_stream(fe.h, data, len(data))
            t1 = time.perf_counter()
            nplans = len(fe.extract_all(n, spss, ppss))
            t2 = time.perf_counter()
            best_push = max(best_push, n / (t1 - t0))
            best_ext = max(best_ext, n / (t2 - t1))
            del fe
    finally:
        if old is None:
            os.environ.pop("FE_THREADS", None)
        else:
            os.environ["FE_THREADS"] = old
    sps = next(iter(spss.values()))
    return {"stream": stream, "threads": threads, "frames": n,
            "plans": nplans, "w": sps.pic_width_in_luma_samples,
            "h": sps.pic_height_in_luma_samples,
            "mbps": len(data) * 8 * 30 / max(n, 1) / 1e6,
            "parse_fps": best_push, "extract_fps": best_ext,
            "pipeline_fps": 1 / (1 / best_push + 1 / best_ext)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_frontend")
    ap.add_argument("out", nargs="?")
    ap.add_argument("--streams", default=",".join(STREAMS))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    rows = [bench(s, t, args.reps)
            for s in args.streams.split(",")
            if os.path.exists(os.path.join(DATA, s + ".bin"))
            for t in (1, 4)]
    lines = "".join(json.dumps(r) + "\n" for r in rows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(lines)
    else:
        sys.stdout.write(lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
