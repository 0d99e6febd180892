"""bench_e2e: end-to-end decode of one stream, the native C++ front end
and a reconstruction backend, with fps and the per-stage split
(counterpart of the JAX package's tools/bench_e2e.py).

    python -m libde265_tpu_torch.tools.bench_e2e stream.bin
        [device|numpy] [iters] [--device cuda|cpu]

device (the default): api.decode_stream_native on --device ("cuda"
unless asked), its stats split into parse, pack and device decode (the
decode synchronised, the output pictures downloaded). numpy: the same
native plans reconstructed by the port's numpy reference
(reconstruct.py), frame by frame on the host. One untimed warm-up decode
(the kernels' build and first launches), then `iters` (default 3) timed
ones; prints one line:

    NAME: N frames, backend=B (DEVICE): S s/stream = F fps (WxH);
    parse P s, pack K s, decode D s
"""
import argparse
import os
import sys
import time


def decode(data, backend, device, stats):
    """Pictures of `data` through `backend`; fills `stats` with parse_s,
    pack_s and decode_s (host seconds)."""
    from ..api import _order_and_crop, _parse, _RefShim, decode_stream_native
    if backend == "device":
        return decode_stream_native(data, device=device, stats=stats)
    from ..plan import grey_planes
    from ..reconstruct import reconstruct_frame
    t0 = time.perf_counter()
    plans = _parse(data)
    t1 = time.perf_counter()
    refs = _RefShim()
    done = []
    for plan in plans:
        if plan.nal_type == -1:           # concealment frame: grey
            planes = grey_planes(plan.sps, plan.W, plan.H)
        else:
            planes = reconstruct_frame(plan, dpb_images=refs)
        refs.add(plan.frame_id, plan, planes)
        if plan.nal_type != -1 and plan.output_flag:
            done.append(plan)
    pics = _order_and_crop(done, refs)
    stats.update(parse_s=t1 - t0, pack_s=0.0,
                 decode_s=time.perf_counter() - t1)
    return pics


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_e2e")
    ap.add_argument("stream")
    ap.add_argument("backend", nargs="?", default="device",
                    choices=("device", "numpy"))
    ap.add_argument("iters", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve
    dev = resolve(args.device)
    with open(args.stream, "rb") as f:
        data = f.read()
    pics = decode(data, args.backend, dev, {})          # warm-up
    n = len(pics)
    split = {"parse_s": 0.0, "pack_s": 0.0, "decode_s": 0.0}
    t0 = time.perf_counter()
    for _ in range(args.iters):
        st = {}
        pics = decode(data, args.backend, dev, st)
        for k in split:
            split[k] += st[k] / args.iters
    dt = (time.perf_counter() - t0) / args.iters
    where = dev.type if args.backend == "device" else "host"
    print(f"{os.path.basename(args.stream)}: {n} frames, backend="
          f"{args.backend} ({where}): {dt:.3f} s/stream = {n / dt:.2f} fps "
          f"({pics[0].width}x{pics[0].height}); parse "
          f"{split['parse_s']:.3f} s, pack {split['pack_s']:.3f} s, decode "
          f"{split['decode_s']:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
