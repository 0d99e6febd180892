"""decode_fps: pictures returned by get_next_picture in the window, over
the whole window (host clock)."""


def read(run):
    n = len(run.pictures)
    return n / run.window_s if n and run.window_s > 0 else None
