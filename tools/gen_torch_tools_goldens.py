#!/usr/bin/env python3
"""Write tests/data/manifest_torch_tools.json: what the JAX package's
command-line tools (tools/*.py) give on fixed inputs, so that a machine
without JAX (the card's) can hold the port's tools
(libde265_tpu_torch/tools/) to it.

  killswitch  per-frame MD5s of `dec265 --disable-deblocking`,
              `--disable-sao` and both (-o, whole frames of the YUV) on
              vectors that span the routes: the frame program at 8 and
              10 bits and at 4:2:2, the hybrid path, the numpy route,
              and a stream that mixes the numpy route with the device
  temporal    per-frame MD5s of `dec265 -T 0` and `-F 50` on p_temporal
  hash_sei    the vectors that carry decoded-picture-hash SEI (for -c)
  sherlock    MD5s of every layer's decoded pixels (PIL) and the frame
              metadata of `sherlock p_cif_mixed.bin -n 2`
  hdrcopy     MD5s of `hdrcopy p_temporal.bin --slices --copy F`'s
              stdout (F written as OUT) and of F
  seeded      a 128x96 8-frame 4:2:0 YUV made by tools_yuv(seed): the
              MD5 and stdout of `enc265`, the points of `rd_curves` on
              all 8 frames and on the first 4 (curves a and b), and the
              stdout of `bjontegaard a b`
  decodestreams  the statuses of the sweep over tests/data, counted by
              kind (OK, FUZZ-FAIL, other), the streams not OK with their
              statuses, and its summary line; the
              sweep decodes every stream with numpy (tens of minutes),
              so --sweep-output takes a saved stdout of
              `python tools/decodestreams.py tests/data` instead

    python tools/gen_torch_tools_goldens.py [--seed N]
        [--sweep-output FILE] [--out FILE]

tests/test_torch_tools.py rebuilds the cheap entries and requires them
equal to the committed file; chip_smoke.py imports tools_yuv,
frame_md5s, html_images and filter0_pixels from here (none imports JAX)
and holds the card's runs to the file.
"""
import argparse
import base64
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
OUT = os.path.join(DATA, "manifest_torch_tools.json")
SEED = 2026
YUV_W, YUV_H, YUV_FRAMES = 128, 96, 8
ENC_ARGS = ["--qp", "32"]
RD_QPS = "22,27,32,37"
SWITCHES = {"deblock": ["--disable-deblocking"], "sao": ["--disable-sao"],
            "both": ["--disable-deblocking", "--disable-sao"]}
# route: p_filters / p_cif_mixed the frame program, adv_wpp_dep10_scaling
# at 10 bits, rext_422_filters at 4:2:2, rxt_cqo the hybrid path,
# rxt_ccp_444 numpy, adv_rot_tsctx_wpp numpy (1 frame) beside the device
KILLSWITCH = ("p_filters", "p_cif_mixed", "adv_wpp_dep10_scaling",
              "rext_422_filters", "rxt_cqo", "rxt_ccp_444",
              "adv_rot_tsctx_wpp")
TEMPORAL = ("p_temporal", {"T0": ["-T", "0"], "F50": ["-F", "50"]})
# fuzzed files the JAX sweep fails on and the port's decodes: the front
# end's grey stand-in for a missing reference decodes before the frame
# that needs it in the port (api._conceal_first); the JAX
# decode_stream_native raises KeyError there
SWEEP_BETTER = ("id_085_adv_ltr_tsa_scaling_flip1",)
SHERLOCK = ("p_cif_mixed", 2)
HDRCOPY = "p_temporal"


def tools_yuv(seed=SEED, w=YUV_W, h=YUV_H, n=YUV_FRAMES):
    """Raw planar 8-bit 4:2:0 bytes of n frames: a seeded random texture,
    box-smoothed, panning 2 columns and 1 row a frame, chroma derived
    from it (integer arithmetic only, so every machine makes the same
    bytes)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    tex = rng.randint(0, 256, (h + n + 2, w + 2 * n + 2)).astype(np.int32)
    for _ in range(2):
        tex = (tex[:-1, :-1] + tex[1:, :-1] + tex[:-1, 1:] + tex[1:, 1:]) // 4
    out = bytearray()
    for t in range(n):
        y = tex[t:t + h, 2 * t:2 * t + w]
        sub = y[::2, ::2]
        for p in (y, 128 + (sub - 128) // 3, 128 - (sub - 128) // 5):
            out += np.clip(p, 0, 255).astype(np.uint8).tobytes()
    return bytes(out)


def frame_md5s(yuv, n):
    """MD5 of each of the n whole frames of a YUV file's bytes."""
    if n == 0:
        return []
    fsz = len(yuv) // n
    return [hashlib.md5(yuv[i * fsz:(i + 1) * fsz]).hexdigest()
            for i in range(n)]


def n_frames(stdout):
    """N of dec265's last line, `nFrames decoded: N (...)`."""
    return int(stdout.strip().splitlines()[-1].split()[2])


def jax_tool(name, argv):
    """(exit code, stdout) of the JAX package's tools/<name>.py run
    in-process with `argv`; the environment is restored after it."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    env, old_argv = dict(os.environ), sys.argv
    sys.argv = [name] + list(argv)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = old_argv
        os.environ.clear()
        os.environ.update(env)
    return rc or 0, buf.getvalue()


def dec265_md5s(argv, stream, tmp):
    """Per-frame MD5s of the JAX dec265's -o output."""
    out = os.path.join(tmp, "out.yuv")
    rc, so = jax_tool("dec265", [*argv, "-o", out,
                                 os.path.join(DATA, stream + ".bin")])
    assert rc == 0, so
    with open(out, "rb") as f:
        return frame_md5s(f.read(), n_frames(so))


def killswitch(tmp, names=KILLSWITCH):
    return {name: {k: dec265_md5s(a, name, tmp) for k, a in
                   SWITCHES.items()} for name in names}


def temporal(tmp):
    name, cases = TEMPORAL
    return {name: {k: dec265_md5s(a, name, tmp) for k, a in cases.items()}}


def hash_sei():
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.sei import parse_sei
    out = []
    for fn in sorted(os.listdir(DATA)):
        if not fn.endswith(".bin") or fn.startswith("id_") or \
                os.path.getsize(os.path.join(DATA, fn)) > 3_000_000:
            continue
        with open(os.path.join(DATA, fn), "rb") as f:
            units = split_annexb(f.read())
        if any(m.picture_hash is not None for u in units
               if u.header.nal_unit_type in (39, 40)
               for m in parse_sei(u.data)):
            out.append(fn[:-4])
    return out


def html_images(html):
    """{frame: {key: PNG bytes}} and the frame metadata of a sherlock
    report."""
    data = meta = None
    for line in html.splitlines():
        if line.startswith("const D = "):
            data = json.loads(line[len("const D = "):].rstrip(";"))
        elif line.startswith("const META = "):
            meta = json.loads(line[len("const META = "):].rstrip(";"))
    return ([{k: base64.b64decode(v) for k, v in d.items()} for d in data],
            meta)


def pixel_md5(a):
    """'MD5 shape' of a pixel array."""
    return f"{hashlib.md5(a.tobytes()).hexdigest()} {a.shape}"


def png_pixel_md5(png):
    """pixel_md5 of a PNG decoded by PIL (the JAX tool's PNGs)."""
    import numpy as np
    from PIL import Image
    return pixel_md5(np.asarray(Image.open(io.BytesIO(png))))


def filter0_pixels(png):
    """The (H, W, 3 or 4) uint8 pixels of an 8-bit RGB or RGBA PNG whose
    rows all use filter 0 (the port's sherlock writes such PNGs), decoded
    with zlib and struct alone; ValueError for any other PNG."""
    import struct
    import zlib
    import numpy as np
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    i, idat, hdr = 8, b"", None
    while i < len(png):
        n, = struct.unpack(">I", png[i:i + 4])
        tag, body = png[i + 4:i + 8], png[i + 8:i + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        i += 12 + n
    w, h, depth, ctype = hdr[:4]
    c = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or c is None:
        raise ValueError(f"PNG of depth {depth}, colour type {ctype}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("a PNG row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


def sherlock(tmp):
    stream, n = SHERLOCK
    out = os.path.join(tmp, "sherlock.html")
    rc, _ = jax_tool("sherlock", [os.path.join(DATA, stream + ".bin"),
                                  "-o", out, "-n", str(n)])
    assert rc == 0
    with open(out) as f:
        imgs, meta = html_images(f.read())
    return {"stream": stream, "frames": n, "meta": meta,
            "pixels": [{k: png_pixel_md5(v) for k, v in d.items()}
                       for d in imgs]}


def hdrcopy(tmp):
    out = os.path.join(tmp, "ps.bin")
    rc, so = jax_tool("hdrcopy", [os.path.join(DATA, HDRCOPY + ".bin"),
                                  "--slices", "--copy", out])
    assert rc == 0
    with open(out, "rb") as f:
        copy = f.read()
    return {"stream": HDRCOPY,
            "stdout_md5": hashlib.md5(so.replace(out, "OUT").encode())
            .hexdigest(),
            "copy_md5": hashlib.md5(copy).hexdigest()}


def seeded(tmp, seed=SEED):
    yuv = os.path.join(tmp, "in.yuv")
    with open(yuv, "wb") as f:
        f.write(tools_yuv(seed))
    geo = ["-w", str(YUV_W), "-h", str(YUV_H)]
    enc_out = os.path.join(tmp, "enc.bin")
    enc_argv = ["-i", yuv, "-o", enc_out, *geo, "-f", str(YUV_FRAMES),
                *ENC_ARGS]
    rc, so = jax_tool("enc265", enc_argv)
    assert rc == 0
    with open(enc_out, "rb") as f:
        enc_md5 = hashlib.md5(f.read()).hexdigest()
    curves = {}
    for k, nf in (("a", YUV_FRAMES), ("b", YUV_FRAMES // 2)):
        path = os.path.join(tmp, f"curve_{k}.json")
        rc, _ = jax_tool("rd_curves", ["-i", yuv, *geo, "-f", str(nf),
                                       "--qps", RD_QPS, "-o", path])
        assert rc == 0
        with open(path) as f:
            curves[k] = {"frames": nf, "points": json.load(f)}
    rc, bd = jax_tool("bjontegaard", [os.path.join(tmp, "curve_a.json"),
                                      os.path.join(tmp, "curve_b.json")])
    return {"seed": seed, "w": YUV_W, "h": YUV_H, "frames": YUV_FRAMES,
            "enc265": {"args": ENC_ARGS, "md5": enc_md5, "stdout": so},
            "rd_curves": {"qps": RD_QPS, **curves}, "bjontegaard": bd}


def sweep_counts(stdout):
    """Statuses of a decodestreams run counted by kind, the streams that
    were not OK with their status, and the summary line."""
    named = dict(ln.split(": ", 1) for ln in stdout.splitlines()
                 if ": " in ln)
    st = list(named.values())
    return {"not_ok": {k: v for k, v in named.items() if v != "OK"},
            "ok": sum(s == "OK" for s in st),
            "fuzz": sum(s.startswith("FUZZ") for s in st),
            "other": sum(not s.startswith(("OK", "FUZZ")) for s in st),
            "summary": [ln for ln in stdout.splitlines()
                        if ln.endswith("streams OK")][-1]}


def decodestreams():
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "decodestreams.py"),
                        DATA], capture_output=True, text=True, check=True)
    return sweep_counts(r.stdout)


def cheap(tmp, seed=SEED):
    """The entries a test rebuilds (seconds)."""
    return {"temporal": temporal(tmp), "hash_sei": hash_sei(),
            "sherlock": sherlock(tmp), "hdrcopy": hdrcopy(tmp),
            "seeded": seeded(tmp, seed)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--sweep-output")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"killswitch": killswitch(tmp), **cheap(tmp, args.seed)}
    if args.sweep_output:
        with open(args.sweep_output) as f:
            out["decodestreams"] = sweep_counts(f.read())
    else:
        out["decodestreams"] = decodestreams()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
