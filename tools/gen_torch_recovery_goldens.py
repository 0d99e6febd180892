#!/usr/bin/env python3
"""Write tests/data/manifest_torch_recovery.json: the recovery cases of the
port's per-picture push decoder (libde265_tpu_torch.api.new_decoder(
parse="python")) with what the JAX package's push decoder
(libde265_tpu.api.new_decoder) gives on them, so that a machine without
JAX (the card's) can hold the port to it.

Each case is a recipe over a committed vector (cases()): a fuzzed file as
it is (or with the decoder's DPB cut to `dpb_size` pictures), explicit
bit flips (chosen, or drawn from a seeded RandomState; kept as [byte,
bit] pairs), a cut after n bytes, or the DPB-overflow construction
of tests/test_robustness.py::test_dpb_overflow_recovers (the parameter
sets, every VCL NAL, then the VCL NALs after the IDR `times` more times).
Every case is pushed in `chunk`-byte pieces (pts 1000 + piece index),
each push followed by decode() until it asks for input, then flushed and
decoded to the end, pictures drained after every decode() (trace). Per
case the file holds the recipe and the JAX decoder's pictures in output
order (poc, per-plane MD5s, pts), its warning codes in order, the
(status, pictures returned) of every decode() and the passed hash checks.
`native` marks the cases that the default segment path must decode to
the same pictures and warnings (its hand-off to the per-picture path).

    python tools/gen_torch_recovery_goldens.py [--out FILE]

tests/test_torch_push_python.py rebuilds the goldens and requires them
equal to the committed file; chip_smoke.py imports build_stream and trace
from here (no JAX) and holds the card's decode to the file.
"""
import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
OUT = os.path.join(DATA, "manifest_torch_recovery.json")
CHUNK = 997


def _flips(source, seed, n=4):
    """n [byte, bit] flips past the first 8 bytes (the VPS start stays),
    as tests/test_robustness.py draws them."""
    import numpy as np
    size = os.path.getsize(os.path.join(DATA, source + ".bin"))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pos = int(rng.randint(8, size))
        out.append([pos, int(rng.randint(8))])
    return out


def cases():
    """name -> recipe."""
    out = {}
    # the fuzzed p_slices2 streams whose plans intra_fused.pack_scan_perms
    # refuses (the default path hands their segment over); SEI hash
    # mismatches on numpy host frames
    for name in ("id_063_p_slices2_flip0", "id_064_p_slices2_flip1",
                 "id_065_p_slices2_flip2"):
        out[name] = dict(source=name, kind="file", native=True)
    out["id_105_rxt_kitchen_flip0"] = dict(source="id_105_rxt_kitchen_flip0",
                                           kind="file")
    # p_mixed's SPS width 64 -> 66 (one bit of its ue(v) code): every
    # slice fails at the right edge (its decoded part kept), and numpy
    # cannot reconstruct a CU that overhangs the picture (grey)
    out["p_mixed_width66"] = dict(source="p_mixed", kind="flips",
                                  flips=[[53, 0]])
    # a WPP stream with dependent slices cut inside a slice: its slice
    # data ends early (SLICE_DATA_CORRUPTED, the decoded part kept)
    out["adv_w1_wpp_dep_cut"] = dict(source="adv_w1_wpp_dep", kind="cut",
                                     bytes=2437)
    # a DPB of 2 pictures: IMAGE_BUFFER_FULL, and the oldest reference
    # dropped (DPB_FULL_PICTURE_DROPPED)
    for name in ("p_2ref", "b_mixed"):
        out[name + "_dpb2"] = dict(source=name, kind="file", dpb_size=2)
    out["p_slices2_flips7"] = dict(source="p_slices2", kind="flips", seed=7,
                                   flips=_flips("p_slices2", 7))
    size = os.path.getsize(os.path.join(DATA, "p_slices2.bin"))
    out["p_slices2_cut75"] = dict(source="p_slices2", kind="cut",
                                  bytes=int(size * 0.75))
    out["p_mixed_dpb_overflow"] = dict(source="p_mixed", kind="repeat_tail",
                                       times=15)
    for r in out.values():
        r.setdefault("native", False)
        r["chunk"] = CHUNK
    return out


def build_stream(recipe, data_dir=DATA):
    """The bytes of a recipe (the port's NAL helpers: no JAX)."""
    with open(os.path.join(data_dir, recipe["source"] + ".bin"), "rb") as f:
        data = f.read()
    kind = recipe["kind"]
    if kind == "file":
        return data
    if kind == "cut":
        return data[:recipe["bytes"]]
    if kind == "flips":
        b = bytearray(data)
        for pos, bit in recipe["flips"]:
            b[pos] ^= 1 << bit
        return bytes(b)
    if kind == "repeat_tail":
        from libde265_tpu_torch.bitstream.nal import split_annexb
        from libde265_tpu_torch.encoder.cabac_enc import \
            add_emulation_prevention as ep
        units = list(split_annexb(data))
        ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
        vcl = [u for u in units if u.header.nal_unit_type < 32]

        def annexb(us):
            return b"".join(b"\x00\x00\x00\x01" + ep(u.data) for u in us)
        return annexb(ps) + annexb(vcl) + annexb(vcl[1:]) * recipe["times"]
    raise ValueError(f"unknown recipe kind {kind!r}")


def trace(api, data, chunk=CHUNK, dpb_size=None, **kw):
    """Push `data` into api.new_decoder(**kw) (its DPB cut to `dpb_size`
    pictures where given) in `chunk`-byte pieces (pts 1000 + piece
    index), each push followed by decode() until it returns False, then
    flush and decode to the end, draining the pictures after every
    decode(). Returns (record dict, decoder): pictures [poc, [MD5
    y, u, v], pts], warnings [codes], steps [[status, pictures
    returned]] of every decode(), hash_checks."""
    dec = api.new_decoder(**kw)
    if dpb_size is not None:
        dec.dpb = type(dec.dpb)(size=dpb_size)
    rec = dict(pictures=[], steps=[], warnings=[], hash_checks=0)

    def drain():
        while True:
            more = api.decode(dec)
            n = 0
            while True:
                p = api.get_next_picture(dec)
                if p is None:
                    break
                rec["pictures"].append(
                    [int(p.poc), [p.plane_md5(c) for c in range(3)], p.pts])
                n += 1
            rec["steps"].append([int(dec.status), n])
            if not more:
                return

    for i in range(0, len(data), chunk):
        api.push_data(dec, data[i:i + chunk], pts=1000 + i // chunk)
        drain()
    api.flush_data(dec)
    drain()
    while True:
        w = api.get_warning(dec)
        if w is None:
            break
        rec["warnings"].append(int(w))
    rec["hash_checks"] = int(getattr(dec, "hash_checks_passed", 0))
    return rec, dec


def goldens():
    """name -> {recipe, jax: trace record} from the JAX push decoder."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import libde265_tpu.api as J
    out = {}
    for name, recipe in cases().items():
        data = build_stream(recipe)
        rec, _ = trace(J, data, recipe["chunk"], recipe.get("dpb_size"))
        out[name] = dict(recipe=recipe,
                         bytes_md5=hashlib.md5(data).hexdigest(), jax=rec)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    g = goldens()
    with open(args.out, "w") as f:
        json.dump(g, f, indent=1, sort_keys=True)
        f.write("\n")
    for name, e in g.items():
        print(f"{name}: {len(e['jax']['pictures'])} pictures, warnings "
              f"{e['jax']['warnings']}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
