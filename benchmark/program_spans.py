"""What the readers of the program's own spans share (metrics/
program_*.py, upload_ms_per_frame, sync_wait_ms_per_frame,
download_ms_per_frame, enqueue_ms_per_frame,
reconstruct_self_ms_per_frame): the spans of the port's telemetry log
(libde265_tpu_torch.telemetry.records()) that start inside a request
outside the profiled stretch, between its t_start and t_end (the
perf_counter clock the client times requests with), and the pictures
those requests returned.

There is nothing to read (None) where the program has no telemetry
module, where no request outside the profiled stretch returned a
picture, or where the log's ring has dropped spans that may have
started inside those requests.
"""
import importlib
from bisect import bisect_left, bisect_right


def window(run):
    """(spans of the requests outside the profiled stretch, pictures
    they returned), or None."""
    try:
        telemetry = importlib.import_module("libde265_tpu_torch.telemetry")
    except ImportError:
        return None
    reqs = run.unprofiled()
    n = sum(len(r.returned) for r in reqs)
    recs = telemetry.records()
    if not n or not recs:
        return None
    # the ring drops the spans that ended first: none of them started in
    # a request if the oldest one kept ended before the first request
    if telemetry.dropped() and recs[0].t1 >= min(r.t_start
                                                 for r in reqs) * 1e9:
        return None
    recs.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in recs]
    out = []
    for r in reqs:
        out += recs[bisect_left(starts, r.t_start * 1e9):
                    bisect_right(starts, r.t_end * 1e9)]
    return out, n


def seconds(spans, name):
    """Total seconds of the spans called `name`, or None where there is
    none."""
    got = [s.t1 - s.t0 for s in spans if s.name == name]
    return sum(got) / 1e9 if got else None


def ms_per_picture(run, name):
    """Milliseconds of the spans called `name` per picture returned, over
    the requests outside the profiled stretch; None where there is
    nothing to read."""
    w = window(run)
    s = w and seconds(w[0], name)
    return None if s is None else s * 1e3 / w[1]
