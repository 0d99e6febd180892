"""bench_intra_scan: a stream's IDR through the frame program's intra
scan (K4), MD5-checked and timed (counterpart of the JAX package's
tools/bench_intra_scan.py).

    python -m libde265_tpu_torch.tools.bench_intra_scan [STREAM] [--fori]
        [--manifest manifest_big.json] [--device cuda|cpu]

STREAM defaults to ld4k_light (tests/data). The IDR decodes through
frame_program.decode_frame_device into DPB slot 0 (K4 for its intra
TUs); its per-plane MD5s are held to the manifest and 10 decodes are
timed (CUDA events on the card, after one warm-up). With --fori the
same IDR is also rebuilt through the port's plain intra path by
wavefront levels, the hybrid device path (device_decode.
reconstruct_frame_device: intra_wavefront.py's levels, ops/intra.py's
batched steps, the same loop filters), once, timed the same way; the
port carries no counterpart of the JAX fori intra_stage (frame_program.
check_slice refuses intra outside the band scan), and this is the path
that plays its part. Prints each time, the MD5 verdict and, with --fori,
whether the two pictures are equal; a mismatch exits 1.
"""
import argparse
import json
import os
import sys

from .bench import DATA, _seconds, device_name, frame_md5s


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_intra_scan")
    ap.add_argument("stream", nargs="?", default="ld4k_light")
    ap.add_argument("--fori", action="store_true")
    ap.add_argument("--manifest", default="manifest_big.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from dataclasses import replace
    from ..api import _parse
    from ..convert import plan_from_numpy
    from ..device import resolve
    from ..device_decode import reconstruct_frame_device
    from ..device_stream import DeviceStreamDecoder
    from ..frame_program import decode_frame_device
    from ..packing import frame_has_intra, pack_frame
    dev = resolve(args.device)
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        plans = _parse(f.read())
    with open(os.path.join(DATA, args.manifest)) as f:
        man = json.load(f)[args.stream]
    i = next(i for i, p in enumerate(plans)
             if p.nal_type != -1 and frame_has_intra(p))
    plan = plans[i]
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    cfg = replace(dec.cfg, skip_mc=True)
    t = plan_from_numpy(pack_frame(plan, cfg, {plan.frame_id: 0}), dev)
    print(f"# {device_name(dev)}: {args.stream} IDR (frame {i}, POC "
          f"{plan.poc}), intra classes {len(cfg.intra)}", flush=True)

    def decode():
        decode_frame_device(*dec.state(), t, 0, cfg)

    decode()                                        # warm-up
    ms = _seconds(dev, decode, 10) * 1e3
    got = frame_md5s(plan, [p[0] for p in dec.state()[:3]], dec.dtype)
    want = [man["md5"][i][c] for c in ("y", "u", "v")]
    ok = got == want
    print(f"MD5 {'MATCH' if ok else f'MISMATCH {got} != {want}'}")
    print(f"I-frame device time: {ms:.3f} ms (band scan, K4)")
    if args.fori:
        planes = []
        ms_f = _seconds(dev, lambda: planes.append(
            reconstruct_frame_device(plan, dec)), 1) * 1e3
        same = frame_md5s(plan, planes[-1], dec.dtype) == got
        print(f"I-frame device time: {ms_f:.3f} ms (wavefront levels, the "
              f"hybrid path, one run)")
        print(f"pictures {'EQUAL' if same else 'DIFFER'} (band scan vs "
              f"wavefront levels)")
        ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
