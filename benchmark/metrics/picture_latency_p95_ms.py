"""picture_latency_p95_ms: per picture, from the start of the push_data
that delivered the last byte of its access unit to the return of the
get_next_picture that gave it; the 95th percentile (nearest rank) over
every picture of the window (host clock)."""
import math


def read(run):
    lat = sorted((p.t_out - p.t_due) * 1e3 for p in run.pictures)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
