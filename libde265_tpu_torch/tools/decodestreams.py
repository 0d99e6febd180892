"""Conformance sweep (counterpart of the JAX package's
tools/decodestreams.py and of libde265's scripts/decodestreams.py):
decode every stream of a directory on the card through
decode_stream_native, each picture held to the MD5s of the directory's
manifests where they list the stream. A stream with a frame that
decode_stream_native's host work refuses before its launches
(device_stream.HostDataError: a damaged plan) is decoded again through
the segment push decoder, which hands such a segment to the per-picture
path, the JAX decoder's recovery. Files named id_* (fuzzed inputs) may
fail; any other failure fails the sweep.

    python -m libde265_tpu_torch.tools.decodestreams [DIR] [--device D]

DIR defaults to tests/data. The streams are shared out over a pool of
min(4, cpu_count) processes started with `spawn` (a forked child of a
process that has used CUDA cannot use it), each decoding on `--device`
("cuda" unless "cpu" is given). A fuzzed file's error is allowed only if
the device still works after it: a worker synchronises the card after
every failure, so a device fault fails the sweep. Prints `name: status`
per stream, then `K/N streams OK`; exit 1 on a failure.
"""
import argparse
import json
import multiprocessing as mp
import os
import sys

MANIFESTS = ("manifest.json", "manifest_inter.json", "manifest_big.json",
             "manifest_rext.json")


def check_one(task):
    """(name, status) of one stream, decoded in a pool worker."""
    name, path, md5s, device = task
    try:
        from ..api import decode_stream, decode_stream_native
        from ..device_stream import HostDataError
        with open(path, "rb") as f:
            data = f.read()
        try:
            pics = decode_stream_native(data, device=device)
        except HostDataError:
            # a damaged frame the host work refuses before its launches:
            # the segment push decoder recovers its segment as the JAX
            # decoder does (decoder.Decoder._decode_segment)
            pics = decode_stream(data, device=device)
        if md5s is not None:
            if len(pics) != len(md5s):
                return (name, f"FRAMES {len(pics)}/{len(md5s)}")
            for i, p in enumerate(pics):
                keys = [k for k in "yuv" if k in md5s[i]]   # mono: y only
                got = [p.plane_md5(c) for c in range(len(keys))]
                want = [md5s[i][k] for k in keys]
                if got != want:
                    return (name, f"MD5 MISMATCH frame {i}")
        return (name, "OK")
    except Exception as e:
        import torch
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)   # a device fault raises here
        if os.path.basename(path).startswith("id_"):
            return (name, f"FUZZ-FAIL (allowed): {e!r:.60}")
        return (name, f"EXC {e!r:.80}")


def tasks_of(data, device):
    """(name, path, md5s or None, device) of every .bin file of `data`,
    by name."""
    manifests = {}
    for mf in MANIFESTS:
        p = os.path.join(data, mf)
        if os.path.exists(p):
            with open(p) as f:
                manifests.update(json.load(f))
    return [(fn[:-4], os.path.join(data, fn),
             manifests.get(fn[:-4], {}).get("md5"), device)
            for fn in sorted(os.listdir(data)) if fn.endswith(".bin")]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="decodestreams")
    ap.add_argument("data", nargs="?", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "data"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tasks = tasks_of(args.data, args.device)
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(4, mp.cpu_count())) as pool:
        results = pool.map(check_one, tasks)
    fails = [r for r in results if not r[1].startswith(("OK", "FUZZ"))]
    for name, status in results:
        print(f"{name}: {status}")
    print(f"\n{len(results) - len(fails)}/{len(results)} streams OK")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
