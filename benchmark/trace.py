"""The device trace of the traced run: torch.profiler over a bounded
stretch of the window, exported as a Chrome trace into TMPDIR, read
back and deleted. The busy time is the union of the kernel, memcpy and
memset intervals (the arithmetic of the port's
profile_frames.summarize, copied here so that the program cannot change
it); the window is the "bench.window" range around the stretch.
"""
import json
import os
import tempfile
from bisect import bisect_left, bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def merged(iv):
    """(start, end) intervals merged into disjoint ones, in order: their
    lengths add up to the union of the input."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> [count, s]
    device_ops: dict = field(default_factory=dict)  # name -> s
    idle_by_span: dict = field(default_factory=dict)  # host span -> s

    @property
    def n_kernels(self):
        return sum(c for c, _ in self.kernels.values())


def summarize(events):
    """TraceSummary of a Chrome trace's event list (times in us)."""
    ev = [e for e in events if e.get("ph") == "X"]
    win = [e for e in ev if e.get("name") == WINDOW]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"))
           for e in ev if e.get("cat") in DEVICE_CATS]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        return None
    dev = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in dev
           if b > w0 and a < w1]
    busy = merged([(a, b) for a, b, _, _ in dev])
    s = TraceSummary(window_s=(w1 - w0) / 1e6,
                     busy_s=sum(b - a for a, b in busy) / 1e6)
    for a, b, n, c in dev:
        s.device_ops[n] = s.device_ops.get(n, 0.0) + (b - a) / 1e6
        if c == "kernel":
            k = s.kernels.setdefault(n, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e6
    # nested host spans; of two that start together the outer one first
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in ev
                    if e.get("name", "").startswith("bench.")
                    and e["name"] != WINDOW), key=lambda x: (x[0], -x[1]))
    starts = [a for a, _, _ in spans]
    cuts = sorted({x for a, b, _ in spans for x in (a, b)})
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        # a gap is cut where a host span begins or ends, each piece
        # labelled by the innermost span that holds it
        pts = [a] + cuts[bisect_right(cuts, a):bisect_left(cuts, b)] + [b]
        for x, y in zip(pts, pts[1:]):
            if y > x:
                idle[_innermost(spans, starts, (x + y) / 2)] += \
                    (y - x) / 1e6
    s.idle_by_span = dict(idle)
    return s


def _innermost(spans, starts, t):
    """Name of the innermost span (the latest-starting one of nested
    spans) that holds time t; "client" where none does."""
    i = bisect_right(starts, t) - 1
    while i >= 0:
        a, b, name = spans[i]
        if a <= t <= b:
            return name
        i -= 1
    return "client"


class Capture:
    """torch.profiler over one stretch, CPU and CUDA activity, with a
    "bench.window" range around it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.rf = record_function(WINDOW)

    def start(self):
        self.prof.__enter__()
        self.rf.__enter__()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def events(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)
