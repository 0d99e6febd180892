"""bench_gop_device: the GOP stream on the device path (counterpart of
the JAX package's tools/bench_gop_device.py).

    python -m libde265_tpu_torch.tools.bench_gop_device [OUT]
        [--stream gop1080p] [--manifest manifest_big.json]
        [--device cuda|cpu]

1. fe_pipelined_device_fps: the 96-frame multi-IRAP 1080p stream through
   DeviceStreamDecoder.decode_all_pipelined(keep_outputs=False), parse
   excluded: a verification round whose resident frames are held to the
   manifest's MD5s, then ROUNDS timed rounds (a fresh parse and
   decoder each, synchronised); a round that does not run every frame
   through the pipeline (n_pipelined_frames short: it fell back to
   decode_all) fails. Beside it the packed bytes per frame and the
   upload rate of an 8 MiB page-locked buffer (link_mbps).
2. In place of the JAX tool's StableHLO collective census: the copies
   that torch.profiler records on the device while
   parallel/gop_shard.decode_gops decodes the stream on
   ["cuda:0"] * LANES (one CUDA stream per entry): peer copies
   (Memcpy PtoP, between devices) and device-to-device copies (Memcpy
   DtoD). The GOP decoders share nothing, so the design keeps both at 0.
3. mesh_wall_s: the wall of that decode (host clock, synchronised, in a
   run of its own without the profiler), with one_card true: every
   entry is the same card, where the JAX tool's virtual CPU mesh shared
   the host's cores (its cpu_shared_cores). Its weak-scaling probe over
   taskset-pinned virtual devices and its REFCOMP.json row (dec265
   rates from another host) have no counterpart on one card.

Prints one JSON line (and writes it to OUT when given).
"""
import argparse
import json
import os
import sys
import time

from .bench import DATA, _sync, device_name, frame_md5s

ROUNDS = 3      # timed pipelined rounds
LANES = 4       # GOP decoder entries, all on the one card


def _md5_check(dec, plans, man):
    """MD5s of every frame still resident in dec's DPB against the
    manifest (decode order is the manifest's order here); returns the
    count checked."""
    idx = {p.frame_id: i for i, p in enumerate(plans)}
    n = 0
    for fid in sorted(dec.slot_of):
        plan = plans[idx[fid]]
        want = [man["md5"][idx[fid]][c] for c in ("y", "u", "v")]
        if frame_md5s(plan, dec.planes_of(fid), dec.dtype) != want:
            raise RuntimeError(f"frame {idx[fid]} (POC {plan.poc}): MD5 "
                               f"differs from the manifest")
        n += 1
    return n


def _pipelined(plans, dev):
    """One decode_all_pipelined run; returns (decoder, host seconds)."""
    from ..device_stream import DeviceStreamDecoder
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    t0 = time.perf_counter()
    dec.decode_all_pipelined(keep_outputs=False)
    _sync(dev)
    dt = time.perf_counter() - t0
    if dec.n_pipelined_frames != len(plans):
        raise RuntimeError(f"decode_all_pipelined ran "
                           f"{dec.n_pipelined_frames} of {len(plans)} "
                           f"frames: it fell back to decode_all")
    return dec, dt


def gop_decode(plans, dev, lanes):
    """(wall s, GOPs) of gop_shard.decode_gops on [dev] * lanes,
    synchronised."""
    from ..parallel.gop_shard import decode_gops
    _sync(dev)
    t0 = time.perf_counter()
    _, st = decode_gops(plans, plans[0].sps, [dev] * lanes)
    _sync(dev)
    return time.perf_counter() - t0, st["n_gops"]


def copy_census(plans, dev, lanes):
    """(peer copies, device-to-device copies) that torch.profiler records
    on the device over gop_decode (zeros on the CPU, which records no
    device copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" \
        else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        gop_decode(plans, dev, lanes)
    # the raw events: building prof.events()' FunctionEvents for ~10^5
    # launches would take longer than the decode
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return (sum("Memcpy PtoP" in n for n in names),
            sum("Memcpy DtoD" in n for n in names))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_gop_device")
    ap.add_argument("out", nargs="?")
    ap.add_argument("--stream", default="gop1080p")
    ap.add_argument("--manifest", default="manifest_big.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch
    from ..api import _parse
    from ..device import resolve
    from ..packing import frame_compatible, pack_frame, stream_cfg
    dev = resolve(args.device)
    with open(os.path.join(DATA, args.manifest)) as f:
        man = json.load(f)[args.stream]
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        data = f.read()

    # ---- 1. the pipelined device decode, MD5-verified, then timed
    t0 = time.perf_counter()
    plans = _parse(data)
    t_parse = time.perf_counter() - t0
    nf = len(plans)
    dec, _ = _pipelined(plans, dev)
    n_checked = _md5_check(dec, plans, man)
    print(f"# verification round: {n_checked} resident frames MD5-equal "
          f"to {args.manifest}", file=sys.stderr, flush=True)
    del dec
    times = [_pipelined(_parse(data), dev)[1] for _ in range(ROUNDS)]
    cfg = stream_cfg(plans, plans[0].sps)
    fid_slot = {p.frame_id: i % 8 for i, p in enumerate(plans)}
    up = sum(a.nbytes for p in plans[:8] if frame_compatible(p)
             for a in pack_frame(p, cfg, fid_slot).values())
    probe = torch.zeros(8 << 20, dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
    _sync(dev)
    t0 = time.perf_counter()
    probe.to(dev, non_blocking=True)
    _sync(dev)
    link = probe.numel() / (time.perf_counter() - t0) / 1e6

    # ---- 2 + 3. the GOP decoder on one card's lanes: its wall (the
    # profiler off), then its copies
    wall, ngops = gop_decode(plans, dev, LANES)
    peer, d2d = copy_census(plans, dev, LANES)
    out = {
        "stream": args.stream, "frames": nf, "device": device_name(dev),
        "fe_parse_fps": nf / t_parse,
        "fe_pipelined_device_fps": nf / min(times),
        "upload_mb_per_frame": up / min(8, nf) / 1e6,
        "link_mbps": link,
        "rounds_s": times,
        "gop_lanes": LANES, "gops": ngops,
        "mesh_wall_s": wall, "one_card": True,
        "peer_copies": peer, "d2d_copies": d2d,
        "note": "the GOP decoders share nothing: no copy between devices "
                "or between their DPBs (parallel/gop_shard.py)",
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
