"""release_batch_frames: the mean number of pictures that one decode()
call made available, over the calls of the window that made any."""


def read(run):
    b = [x for r in run.requests for x in r.batches]
    return sum(b) / len(b) if b else None
