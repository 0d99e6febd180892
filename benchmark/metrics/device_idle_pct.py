"""device_idle_pct: 100 x (1 - the union of kernel, memcpy and memset
intervals over the profiled window), from the profiler trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
