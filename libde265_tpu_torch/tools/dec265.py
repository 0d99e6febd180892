"""dec265: decode an HEVC stream on the card (counterpart of the JAX
package's tools/dec265.py and of libde265's dec265).

    python -m libde265_tpu_torch.tools.dec265 [options] stream.bin
      -o FILE     write the decoded pictures as planar YUV
      -c          check every picture against its SEI decoded-picture
                  hash; exit 1 on a mismatch
      -m FILE     PSNR of each picture against a reference 4:2:0 YUV
      -n          the native C++ front end (the default route)
      -q          quiet
      --frames N  keep the first N pictures
      -T TID      decode only temporal sub-layers <= TID
      -F PERCENT  decode only this percent of the frame rate
      --disable-deblocking, --disable-sao
                  skip that in-loop filter in every picture
      --device D  "cuda" (the default) or "cpu"

Routes, all reconstructing on `--device`: decode_stream_native by
default; with -c the segment push decoder (new_decoder(parse="native")),
which decodes each IDR-to-IDR segment as decode_stream_native does and
checks each coded picture against the hash SEI that follows it, on its
uncropped planes at its bit depth; with -T, -F or a kill-switch the
per-picture push decoder (new_decoder(parse="python")), whose front end
carries the temporal gates. The kill-switches set DE265_DISABLE_DEBLOCK /
DE265_DISABLE_SAO, which every route honours (device_stream.
switch_filters on the device routes, reconstruct.py on the numpy one).
The last line is `nFrames decoded: N (WxH @ F fps)`.
"""
import argparse
import os
import sys
import time


def _push_decode(data, parse, device, tid, ratio):
    """(pictures in output order, decoder) of the push API."""
    from .. import api
    dec = api.new_decoder(parse=parse, device=device)
    if tid is not None:
        dec.set_limit_tid(tid)
    if ratio is not None:
        dec.set_framerate_ratio(ratio)
    api.push_data(dec, data)
    api.flush_data(dec)
    while api.decode(dec):
        pass
    pics = []
    while True:
        p = api.get_next_picture(dec)
        if p is None:
            return pics, dec
        pics.append(p)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dec265")
    ap.add_argument("stream")
    ap.add_argument("-o", "--output")
    ap.add_argument("-c", "--check-hash", action="store_true")
    ap.add_argument("-m", "--measure")
    ap.add_argument("-n", "--native", action="store_true", default=None)
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("-T", "--highest-tid", type=int, default=None,
                    help="decode only temporal sub-layers <= TID")
    ap.add_argument("-F", "--framerate-ratio", type=int, default=None,
                    help="decode only this percent of the frame rate "
                         "(drops highest temporal layers)")
    ap.add_argument("--disable-deblocking", action="store_true",
                    help="debug: skip the deblocking filter")
    ap.add_argument("--disable-sao", action="store_true",
                    help="debug: skip the SAO filter")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    native = True
    if args.disable_deblocking:
        os.environ["DE265_DISABLE_DEBLOCK"] = "1"
        native = False
    if args.disable_sao:
        os.environ["DE265_DISABLE_SAO"] = "1"
        native = False
    if args.highest_tid is not None or args.framerate_ratio is not None:
        native = False

    with open(args.stream, "rb") as f:
        data = f.read()
    t0 = time.time()
    hash_fail = 0
    if native and not args.check_hash:
        from ..api import decode_stream_native
        pics = decode_stream_native(data, device=args.device)
    else:
        pics, dec = _push_decode(data, "native" if native else "python",
                                 args.device, args.highest_tid,
                                 args.framerate_ratio)
        hash_fail = sum("MISMATCH" in w for w in dec.warnings)
    dt = time.time() - t0
    if args.frames:
        pics = pics[:args.frames]

    if args.output:
        with open(args.output, "wb") as f:
            for p in pics:
                f.write(p.to_yuv_bytes())
    if args.measure and pics:
        from ..utils.quality import psnr_yuv
        with open(args.measure, "rb") as f:
            ref = f.read()
        w, h = pics[0].width, pics[0].height
        fsz = w * h * 3 // 2
        for i, p in enumerate(pics):
            vals = psnr_yuv(p.planes, ref[i * fsz:(i + 1) * fsz], w, h)
            print(f"frame {i}: PSNR Y {vals[0]:.2f} U {vals[1]:.2f} "
                  f"V {vals[2]:.2f}")
    if args.check_hash and hash_fail:
        print(f"HASH MISMATCH on {hash_fail} frame(s)")
        return 1
    n = len(pics)
    dim = f"{pics[0].width}x{pics[0].height}" if pics else "?"
    print(f"nFrames decoded: {n} ({dim} @ {n / dt:.2f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
