"""launches_per_frame: CUDA kernel events in the profiler trace of the
profiled stretch, per picture returned in it."""


def read(run):
    n = sum(len(r.returned) for r in run.profiled())
    if run.trace is None or not n:
        return None
    return run.trace.n_kernels / n
