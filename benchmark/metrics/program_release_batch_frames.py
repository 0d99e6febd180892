"""program_release_batch_frames: the mean n of the program's own
"api.decode" spans (the pictures a decode() call added to the output
queue) over the calls that added any, in the requests outside the
profiled stretch (traced run): the program's version of
release_batch_frames."""
from benchmark.program_spans import window


def read(run):
    w = window(run)
    b = [s.n for s in w[0] if s.name == "api.decode" and s.n > 0] \
        if w else []
    return sum(b) / len(b) if b else None
