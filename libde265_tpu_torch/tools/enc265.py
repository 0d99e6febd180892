"""enc265: encode a planar 8-bit 4:2:0 YUV file with the port's encoder
(counterpart of the JAX package's tools/enc265.py and of libde265's
enc265). The encoder runs on the host (numpy), as the JAX one does.

    python -m libde265_tpu_torch.tools.enc265 -i in.yuv -o out.bin \
        -w W -h H [-f N] [--sop-structure intra|low-delay] \
        [--cu-size 8|16|32] [--deblock] [every option of
        utils.configparam.encoder_parameters(), e.g. --qp 32]
"""
import argparse
import sys

import numpy as np


def read_yuv420(path, w, h, frames=0):
    """The [Y, Cb, Cr] uint8 planes of each 4:2:0 frame of a raw file
    (at most `frames` of them unless 0)."""
    fsz = w * h * 3 // 2
    with open(path, "rb") as f:
        raw = f.read()
    nf = len(raw) // fsz
    if frames:
        nf = min(nf, frames)
    cw, ch = w // 2, h // 2
    out = []
    for t in range(nf):
        b = t * fsz
        out.append([
            np.frombuffer(raw[b:b + w * h], np.uint8).reshape(h, w),
            np.frombuffer(raw[b + w * h:b + w * h + cw * ch],
                          np.uint8).reshape(ch, cw),
            np.frombuffer(raw[b + w * h + cw * ch:b + fsz],
                          np.uint8).reshape(ch, cw)])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="enc265", add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", default="out.bin")
    ap.add_argument("-w", "--width", type=int, required=True)
    ap.add_argument("-h", "--height", type=int, required=True)
    ap.add_argument("-f", "--frames", type=int, default=0)
    ap.add_argument("--sop-structure", choices=["intra", "low-delay"],
                    default="low-delay")
    ap.add_argument("--cu-size", type=int, choices=[8, 16, 32], default=16)
    ap.add_argument("--deblock", action="store_true")
    # every registered encoder option is a flag (configparam's auto-CLI)
    from ..utils.configparam import encoder_parameters
    params = encoder_parameters()
    params.add_to_argparser(ap)
    args = ap.parse_args(argv)

    from ..encoder import Encoder, EncoderConfig
    w, h = args.width, args.height
    frames = read_yuv420(args.input, w, h, args.frames)
    cfg = EncoderConfig(
        width=w, height=h,
        intra_period=1 if args.sop_structure == "intra" else 0,
        inter_residual=True,
        cu_log2={8: 3, 16: 4, 32: 5}[args.cu_size],
        disable_deblocking=not args.deblock)
    params.apply_args(cfg, args)        # options the user set win
    stream = Encoder(cfg).encode(frames)
    with open(args.output, "wb") as f:
        f.write(stream)
    print(f"encoded {len(frames)} frames -> {len(stream)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
