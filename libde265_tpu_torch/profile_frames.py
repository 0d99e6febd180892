"""Where a frame's device time goes: torch.profiler over the frame
program for the IDR and one P frame of a stream, on one CUDA card.

    python -m libde265_tpu_torch.profile_frames [STREAM] [OUT_DIR]

STREAM defaults to ld4k_light (tests/data), OUT_DIR to profile_out/.
For each frame kind it prints the wall milliseconds per frame (CUDA
events, profiler off and on), the device busy time (union of kernel, memcpy and
memset intervals) and its share of the window, the kernel launches per
frame, the device span, kernel time and kernel launches of each
frame-program stage (the profiler ranges "de265.<stage>" of the
telemetry spans of frame_program.py), the device's idle time by the
innermost "de265.*" host range that holds it (telemetry.py), and the
top kernels; the Chrome traces go to OUT_DIR/trace_<kind>.json.

    python -m libde265_tpu_torch.profile_frames --tiles [STREAM] [OUT_DIR]

does the same for the first P frame of a tile-column stream (default
p_tiles4_1080p_mv) through the tile-column decoder's strip program, every
strip on the one card (the ranges of parallel/tile_shard.py; trace
OUT_DIR/trace_strip_p.json).

    python -m libde265_tpu_torch.profile_frames --summarize TRACE REPS

prints the same summary of an exported trace of REPS frames.
`wavefront_steps` gives K4's critical path in TU steps (chip_smoke.py
logs it beside each IDR's time).
"""
import json
import os
import sys
from bisect import bisect_left, bisect_right
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .api import _parse
from .convert import plan_from_numpy
from .device_stream import DeviceStreamDecoder, ShardedStreamDecoder
from .frame_program import decode_frame_device
from .packing import pack_frame
from .parallel.tile_shard import decode_frame_tiles, split_strips
from .telemetry import PREFIX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv):
    total, end = 0.0, float("-inf")
    for a, b in sorted(iv):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _merged(iv):
    """(start, end) intervals merged into disjoint ones, in order."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_range(ev, dev):
    """{range: ms}: the device's idle time (outside the intervals `dev`,
    (start, end) in us) from the trace's first event to the end of its
    last, cut where a host range "de265.<name>" begins or ends, each
    piece put down to the innermost range that holds it (the one that
    started last), "none" where none does."""
    if not ev:
        return {}
    w0 = min(e["ts"] for e in ev)
    w1 = max(e["ts"] + e["dur"] for e in ev)
    busy = [[w0, w0]] + _merged(dev) + [[w1, w1]]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                    for e in ev if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda x: (x[0], -x[1]))
    starts = [a for a, _, _ in spans]
    cuts = sorted({x for a, b, _ in spans for x in (a, b)})
    idle = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        pts = [a] + cuts[bisect_right(cuts, a):bisect_left(cuts, b)] + [b]
        for x, y in zip(pts, pts[1:]):
            idle[_innermost(spans, starts, (x + y) / 2)] += (y - x) / 1e3
    return dict(idle)


def _innermost(spans, starts, t):
    i = bisect_right(starts, t) - 1
    while i >= 0:
        a, b, name = spans[i]
        if a <= t <= b:
            return name
        i -= 1
    return "none"


def summarize(trace_path, reps):
    """(busy ms/frame, kernels/frame, {stage: [span ms, kernel ms,
    kernels]}, [(kernel, ms)], {host range: idle ms}) per frame from an
    exported Chrome trace of `reps` frames. A stage is a range on the
    device's timeline (the "de265." prefix dropped); the idle time is
    idle_by_range's."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
           if e.get("cat") in DEVICE_CATS]
    busy = _union([(a, b) for a, b, _ in dev]) / 1e3 / reps
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in ev
            if e.get("cat") == "kernel"]
    stages = defaultdict(lambda: [0.0, 0.0, 0.0])
    for e in ev:
        if e.get("cat") != "gpu_user_annotation":
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        name = e["name"]
        st = stages[name[len(PREFIX):] if name.startswith(PREFIX)
                    else name]
        st[0] += e["dur"] / 1e3 / reps
        st[1] += _union([(x, y) for x, y, _ in dev
                         if x >= a and y <= b]) / 1e3 / reps
        st[2] += sum(1 for x, y in kern if x >= a and y <= b) / reps
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = {k: v / reps for k, v in
            idle_by_range(ev, [(a, b) for a, b, _ in dev]).items()}
    return busy, len(kern) / reps, dict(stages), top, idle


def report(label, trace_path, reps, wall=None):
    """Print the summary of one exported trace."""
    busy, nk, stages, top, idle = summarize(trace_path, reps)
    share = f" ({100 * busy / wall:.1f}% of the profiled window)" \
        if wall else ""
    print(f"{label}: device busy {busy:.3f} ms{share}; {nk:.1f} kernel "
          f"launches per frame")
    for name, (span, kms, kn) in stages.items():
        print(f"  stage {name:9s} span {span:8.3f} ms, device busy "
              f"{kms:8.3f} ms, {kn:7.1f} kernels")
    for name, ms in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  idle {ms:8.3f} ms while the host is in {name}")
    for name, ms in top[:12]:
        print(f"  {ms:8.3f} ms  {name[:100]}")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() over `reps` calls, between two
    CUDA events on the current stream."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile_call(fn, reps, trace_path):
    """(wall ms/frame with the profiler off, and on); writes the trace."""
    fn()
    torch.cuda.synchronize()
    off = cuda_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = cuda_ms(fn, reps)
    prof.export_chrome_trace(trace_path)
    return off, on


def frame_calls(plans, dev):
    """[(kind, fn, reps)]: fn decodes the stream's IDR ("idr") or its
    first P frame ("p") through decode_frame_device, from plans packed
    and uploaded once here; reps is how many calls to time."""
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    i0, p1 = plans[0], plans[1]
    slots = {i0.frame_id: 0, p1.frame_id: 1}
    cfg_i = replace(dec.cfg, skip_mc=True)
    ti = plan_from_numpy(pack_frame(i0, cfg_i, slots), dev)
    tp = plan_from_numpy(pack_frame(p1, dec.cfg_scan, slots), dev)
    return [("idr", lambda: decode_frame_device(*dec.state(), ti, 0, cfg_i),
             2),
            ("p", lambda: decode_frame_device(*dec.state(), tp, 1,
                                              dec.cfg_scan), 5)]


def tile_calls(plans, dev):
    """[("strip_p", fn, reps)]: fn decodes the first P frame of a
    tile-column stream through the strip program, one strip per tile
    column, all on `dev`, after ShardedStreamDecoder.decode_all has
    decoded the stream once; the host split is done once here, the
    strips' uploads run in every call. The frame is re-decoded into its
    own slot from the same references."""
    ndev = plans[0].pps.num_tile_columns
    dec = ShardedStreamDecoder(plans, plans[0].sps, [dev] * ndev)
    dec.decode_all()
    plan = plans[1]
    tsh, trep, x0w = split_strips(plan, dec.cfg_scan, dec.slot_of, ndev)
    slot = dec.slot_of[plan.frame_id]
    return [("strip_p", lambda: decode_frame_tiles(
        dec.replicas, dec.devices, tsh, trep, x0w, slot, dec.cfg_scan), 5)]


def wavefront_steps(recs, K, need):
    """Critical path of K4's wavefront in TU steps, every TU counted as
    one step: band b's slot p finishes at f(b, p) = max(f(b, p'), f(b-1,
    need - 1)) + 1, p' the band's previous valid slot; `need` is
    band_waits(recs, K, BW). Returns (steps, valid TUs); the serial walk
    takes one step per valid TU."""
    r = recs.cpu().numpy().reshape(-1, int(K))
    nd = need.cpu().numpy().reshape(-1, int(K)).astype(np.int64)
    valid = ((r >> 27) & 1) != 0
    prev = np.zeros(int(K), np.int64)       # f(b-1, p), 0 for none
    steps = 0
    for v, w in zip(valid, nd):
        cnt = np.cumsum(v)
        start = np.where(v & (w > 0), prev[np.maximum(w - 1, 0)], 0)
        f = cnt + np.maximum.accumulate(np.where(v, start - cnt + 1, 0))
        prev = np.where(v, f, 0)
        prev = np.maximum.accumulate(prev)
        steps = max(steps, int(prev[-1]))
    return steps, int(valid.sum())


def main(argv):
    if argv[:1] == ["--summarize"]:
        report(argv[1], argv[1], int(argv[2]))
        return
    tiles = argv[:1] == ["--tiles"]
    argv = argv[1:] if tiles else argv
    stream = argv[0] if argv else \
        ("p_tiles4_1080p_mv" if tiles else "ld4k_light")
    out = argv[1] if len(argv) > 1 else os.path.join(REPO, "profile_out")
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cuda")
    with open(os.path.join(REPO, "tests", "data", stream + ".bin"),
              "rb") as f:
        plans = _parse(f.read())
    print(torch.cuda.get_device_name(0), flush=True)
    for kind, fn, reps in (tile_calls if tiles else frame_calls)(plans, dev):
        path = os.path.join(out, f"trace_{kind}.json")
        off, wall = profile_call(fn, reps, path)
        print(f"{stream} {kind}: wall {off:.3f} ms/frame profiler off, "
              f"{wall:.3f} ms on")
        report(f"{stream} {kind}", path, reps, wall)


if __name__ == "__main__":
    main(sys.argv[1:])
