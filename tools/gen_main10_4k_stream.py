#!/usr/bin/env python3
"""Generate ld4k_main10, a 3840x2160 10-bit 4:2:0 (HEVC Main 10) stream,
and its golden per-plane MD5s.

The settings are ld4k_light's (tools/gen_bench_stream.py --light): a
true-motion pan (global MV (-20, -12) qpel), qp 37, 64x64 CTBs, 16x16
CUs, two L0 references, temporal MVP, deblocking and SAO on; the stream
is an IDR and 8 P frames. The content is make_frames_light's, rendered at
10 bits: the same pan, box and chroma waves rounded to 10 bits instead of
8, so the two extra bits carry the content's own detail, not zeros.

dec265 is not part of the tree, so the golden comes from the JAX
package's DeviceStreamDecoder (on the CPU). The encoder reconstructs
every frame with the decoder's own ops; its reconstruction of each frame
(after deblocking and SAO) must equal the JAX decode of that frame before
the MD5s (of 16-bit little-endian samples) are written to
tests/data/manifest_torch.json. If they differ, nothing is written and the
script exits non-zero.

    python tools/gen_main10_4k_stream.py [n_frames]
"""
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")

NAME = "ld4k_main10"
W, H, QP, BIT_DEPTH = 3840, 2160, 37, 10
SETTINGS = dict(inter_mode="gmv", global_mv=(-20, -12), inter_residual=True,
                log2_ctb=6, cu_log2=4, num_ref_l0=2, temporal_mvp=True,
                disable_deblocking=False, sao=True)


def make_frames_main10(n, w, h):
    """make_frames_light (tools/gen_bench_stream.py) at 10 bits: the same
    formulas scaled by 4 before rounding (the box at 842, not 840)."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.clip(np.rint(4 * (90 + 70 * np.sin(gx / 37.0)
                                * np.cos(gy / 29.0)
                                + 25 * np.sin((gx + 2 * gy) / 111.0))),
                   0, 1023).astype(np.uint16)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    frames = []
    for t in range(n):
        y = np.roll(base, (t * 3, t * 5), (0, 1)).copy()
        bx, by = (31 * t) % (w - 256), (17 * t) % (h - 256)
        y[by:by + 256, bx:bx + 256] = 842
        u = np.clip(np.rint(4 * (128 + 50 * np.sin(cx / 41.0 + t * .4))),
                    0, 1023).astype(np.uint16)
        v = np.clip(np.rint(4 * (128 + 50 * np.cos(cy / 33.0 - t * .2))),
                    0, 1023).astype(np.uint16)
        frames.append([y, u, v])
    return frames


def _md5s(planes):
    return {k: hashlib.md5(np.ascontiguousarray(p, "<u2").tobytes())
            .hexdigest() for k, p in zip(("y", "u", "v"), planes)}


def _parse(data):
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.paramsets import read_pps, read_sps
    from libde265_tpu.native_frontend import NativeFrontend
    spss, ppss = {}, {}
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        if t == 33:
            s = read_sps(u.data)
            spss[s.seq_parameter_set_id] = s
        elif t == 34:
            p = read_pps(u.data, spss)
            ppss[p.pic_parameter_set_id] = p
    return NativeFrontend().parse(data, spss, ppss)


def main():
    from libde265_tpu.device_stream import DeviceStreamDecoder
    from libde265_tpu.encoder import Encoder, EncoderConfig

    nframes = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP,
                                bit_depth=BIT_DEPTH, **SETTINGS))
    # the encoder's reconstruction of each frame (after its in-loop
    # filters), read after every frame it codes
    recon = []
    encode_frame = enc._encode_frame

    def encode_and_keep(planes, poc, intra):
        t0 = time.time()
        out = encode_frame(planes, poc, intra)
        recon.append([p.copy() for p in enc.recon])
        print(f"frame {poc}: {len(out)} bytes in {time.time() - t0:.0f} s",
              flush=True)
        return out

    enc._encode_frame = encode_and_keep
    stream = enc.encode(make_frames_main10(nframes, W, H))
    print(f"{NAME}: {len(stream)} bytes", flush=True)

    t0 = time.time()
    plans = _parse(stream)
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    assert len(outs) == nframes, len(outs)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    want = [_md5s(dec.planes_of(p.frame_id)) for p in outs]
    print(f"JAX decode: {time.time() - t0:.0f} s", flush=True)
    assert all(dec.frames[p.frame_id]["fast"] for p in plans), \
        "a frame left the JAX frame program"
    enc_md5 = [_md5s(r) for r in recon]
    bad = [i for i, (a, b) in enumerate(zip(want, enc_md5)) if a != b]
    if bad:
        print(f"{NAME}: the JAX decode and the encoder's reconstruction "
              f"differ on frames {bad}; no golden written", file=sys.stderr)
        sys.exit(1)

    with open(os.path.join(DATA, NAME + ".bin"), "wb") as f:
        f.write(stream)
    path = os.path.join(DATA, "manifest_torch.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest[NAME] = {
        "w": W, "h": H, "frames": nframes, "bit_depth": BIT_DEPTH,
        "size_bytes": len(stream), "md5": want,
        "golden": ("libde265_tpu DeviceStreamDecoder (CPU), equal on every "
                   "frame to the encoder's own reconstruction; dec265 not "
                   "run; MD5s of 16-bit little-endian samples"),
        "encoder": dict(tool="tools/gen_main10_4k_stream.py",
                        frames="make_frames_main10 (make_frames_light at "
                               "10 bits)",
                        qp=QP, bit_depth=BIT_DEPTH,
                        **{k: list(v) if isinstance(v, tuple) else v
                           for k, v in SETTINGS.items()}),
    }
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{NAME}: {nframes} frames, the JAX decode equals the encoder's "
          f"reconstruction; golden written to {path}", flush=True)


if __name__ == "__main__":
    main()
