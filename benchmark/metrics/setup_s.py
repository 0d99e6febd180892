"""setup_s: from the start of the process to the first timed push:
imports, CUDA initialisation, loading (on a checkout's first run,
building) the kernel library and the front end, and the untimed warm-up
requests."""


def read(run):
    return run.setup_s
