"""host_cpu_ms_per_frame: the process's user + system CPU time over the
window (getrusage, every thread of the process, the front end's parse
threads included), per picture returned."""


def read(run):
    n = len(run.pictures)
    return run.cpu_s * 1e3 / n if n else None
