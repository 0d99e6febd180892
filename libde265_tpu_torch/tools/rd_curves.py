"""Rate-distortion points of the port's encoder (counterpart of the JAX
package's tools/rd_curves.py and of libde265's rd-curves): encode a
planar 8-bit 4:2:0 YUV at several QPs (host), decode each stream on the
card through decode_stream_native, and report kbit/s against luma PSNR.

    python -m libde265_tpu_torch.tools.rd_curves -i in.yuv -w W -h H \
        [-f N] [--qps 22,27,32,37] [--fps 25] [--rdo] [-o curve.json] \
        [--device cuda|cpu]
"""
import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rd_curves", add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-w", "--width", type=int, required=True)
    ap.add_argument("-h", "--height", type=int, required=True)
    ap.add_argument("-f", "--frames", type=int, default=4)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--rdo", action="store_true",
                    help="RD-optimized mode decision (encoder/rdo.py)")
    ap.add_argument("-o", "--out", help="write curve JSON to file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..api import decode_stream_native
    from ..encoder import Encoder, EncoderConfig
    from ..utils.quality import psnr
    from .enc265 import read_yuv420
    w, h = args.width, args.height
    frames = read_yuv420(args.input, w, h, args.frames)
    nf = len(frames)
    points = []
    for qp in (int(q) for q in args.qps.split(",")):
        # motion-searched inter ("mv") for anchor and RDO runs alike
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, rdo=args.rdo,
                                    inter_mode="mv", inter_residual=True))
        stream = enc.encode(frames)
        pics = decode_stream_native(stream, device=args.device)
        py = np.mean([psnr(p.planes[0], frames[i][0])
                      for i, p in enumerate(pics)])
        kbps = len(stream) * 8 * args.fps / nf / 1000
        points.append({"qp": qp, "kbps": round(kbps, 1),
                       "psnr_y": round(float(py), 2)})
        print(f"qp={qp}: {kbps:.1f} kbit/s, PSNR-Y {py:.2f} dB")
    print(json.dumps(points))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(points, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
