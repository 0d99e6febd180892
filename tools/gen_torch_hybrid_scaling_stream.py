#!/usr/bin/env python3
"""Generate tests/data/rxt_cqo_scaling.bin: a 64x64 stream whose every frame
takes the hybrid device path with scaling lists on, and its golden
per-plane MD5s in tests/data/manifest_torch.json.

The settings are rxt_cqo's (tools/gen_rext_tool_streams.py: the PPS chroma
QP offset list ((3, -3), (-5, 5)) with cu_chroma_qp_offset per CU, so the
frame program refuses every frame; SAO and deblocking on; mixed inter CUs
with residuals) plus the SPS default scaling lists and 4x4 transform skip.
The stream is an IDR and 3 P frames of seeded content, with a picture-hash
SEI after each.

The stream is encoded with the PyTorch port's encoder
(libde265_tpu_torch.encoder) and with the JAX package's; the two must
write the same bytes. dec265 is not part of the tree, so the golden is
written only where three decodes agree on every frame: the JAX package's
numpy reference (libde265_tpu.api.decode_stream_native, backend "numpy"),
its DeviceStreamDecoder, which must take every frame through its hybrid
device path, and the encoder's own reconstruction. Otherwise nothing is
written and the script exits non-zero.

    python tools/gen_torch_hybrid_scaling_stream.py [--out DIR]

--out writes the stream and an updated copy of manifest_torch.json into
DIR instead of tests/data (the copy starts from tests/data's).
"""
import argparse
import hashlib
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")

NAME = "rxt_cqo_scaling"
W, H, FRAMES, SEED = 64, 64, 4, 2012
SETTINGS = dict(qp=30, inter_mode="mixed", inter_residual=True, log2_ctb=5,
                cu_log2=4, chroma_qp_offset_list=((3, -3), (-5, 5)),
                scaling_lists=True, transform_skip=True, sao=True,
                disable_deblocking=False, write_hash_sei=True)


def make_frames(n, w, h, seed=SEED):
    """8-bit 4:2:0 content: an 8x8-blocky random field with mild noise
    (gen_rext_streams.gen_frames' texture), panned by (1, 2) samples a
    frame so the P frames find their content in the references."""
    rng = np.random.RandomState(seed)

    def plane(ph, pw):
        a = rng.randint(0, 256, (ph // 8 + 2 * n, pw // 8 + 2 * n))
        a = np.kron(a, np.ones((8, 8), np.int64))
        return [np.clip(a[t:t + ph, 2 * t:2 * t + pw]
                        + rng.randint(-9, 10, (ph, pw)), 0, 255)
                .astype(np.uint8) for t in range(n)]

    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    return [[y[t], u[t], v[t]] for t in range(n)]


def _md5s(planes):
    return {k: hashlib.md5(np.ascontiguousarray(p, np.uint8).tobytes())
            .hexdigest() for k, p in zip(("y", "u", "v"), planes)}


def encode(frames):
    """(stream, the encoder's reconstruction of each frame) from the
    port's encoder; the JAX encoder must write the same bytes."""
    from libde265_tpu.encoder import Encoder as JaxEncoder
    from libde265_tpu.encoder import EncoderConfig as JaxConfig
    from libde265_tpu_torch.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=W, height=H, **SETTINGS))
    recon = []
    encode_frame = enc._encode_frame

    def encode_and_keep(*a):
        out = encode_frame(*a)
        recon.append([p.copy() for p in enc.recon])
        return out
    enc._encode_frame = encode_and_keep
    stream = enc.encode(frames)
    jax_stream = JaxEncoder(JaxConfig(width=W, height=H, **SETTINGS)) \
        .encode(frames)
    if stream != jax_stream:
        sys.exit(f"{NAME}: the port's encoder wrote {len(stream)} bytes, "
                 f"the JAX encoder's differ ({len(jax_stream)} bytes)")
    return stream, recon


def jax_decodes(stream):
    """([numpy reference MD5s], [hybrid-path MD5s]) per output frame."""
    from libde265_tpu.api import decode_stream_native
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.paramsets import read_pps, read_sps
    from libde265_tpu.device_stream import DeviceStreamDecoder
    from libde265_tpu.frame_program import (frame_compatible,
                                            frame_uses_rext_tools)
    from libde265_tpu.native_frontend import NativeFrontend
    ref = [_md5s(p.planes) for p in decode_stream_native(stream)]
    spss, ppss = {}, {}
    for u in split_annexb(stream):
        if u.header.nal_unit_type == 33:
            s = read_sps(u.data)
            spss[s.seq_parameter_set_id] = s
        elif u.header.nal_unit_type == 34:
            p = read_pps(u.data, spss)
            ppss[p.pic_parameter_set_id] = p
    plans = NativeFrontend().parse(stream, spss, ppss)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    if not all(not dec.frames[p.frame_id]["fast"] and not frame_compatible(p)
               and not frame_uses_rext_tools(p) for p in plans):
        sys.exit(f"{NAME}: a frame did not take the JAX hybrid device path")
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    return ref, [_md5s(dec.planes_of(p.frame_id)) for p in outs]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DATA, help="output directory")
    args = ap.parse_args()
    stream, recon = encode(make_frames(FRAMES, W, H))
    ref, hybrid = jax_decodes(stream)
    enc = [_md5s(r) for r in recon]
    if not (len(ref) == len(hybrid) == len(enc) == FRAMES
            and ref == hybrid == enc):
        sys.exit(f"{NAME}: the numpy reference, the JAX hybrid path and the "
                 f"encoder's reconstruction differ; no golden written")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, NAME + ".bin"), "wb") as f:
        f.write(stream)
    path = os.path.join(args.out, "manifest_torch.json")
    with open(path if os.path.exists(path)
              else os.path.join(DATA, "manifest_torch.json")) as f:
        manifest = json.load(f)
    manifest[NAME] = {
        "w": W, "h": H, "frames": FRAMES, "bit_depth": 8,
        "size_bytes": len(stream), "md5": ref,
        "golden": ("libde265_tpu's numpy reference and its DeviceStreamDecoder"
                   " (CPU, every frame through its hybrid device path), equal"
                   " on every frame to the encoder's own reconstruction; "
                   "dec265 not run"),
        "encoder": dict(tool="tools/gen_torch_hybrid_scaling_stream.py",
                        frames=f"make_frames(seed={SEED})",
                        **{k: [list(p) for p in v] if k ==
                           "chroma_qp_offset_list" else v
                           for k, v in SETTINGS.items()}),
    }
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{NAME}: {FRAMES} frames, {len(stream)} bytes, the same from both "
          f"encoders; the numpy reference, the JAX hybrid path and the "
          f"encoder's reconstruction agree; golden written to {path}")


if __name__ == "__main__":
    main()
