"""drive_ms_per_frame: wall time inside the push API calls less the
parse and reconstruct spans inside them, per picture, over the requests
outside the profiled stretch (traced run)."""


def read(run):
    reqs = run.unprofiled()
    n = sum(len(r.returned) for r in reqs)
    if not n or not any("drive" in r.spans for r in reqs):
        return None
    s = sum(r.spans.get("drive", 0.0) - r.spans.get("parse", 0.0)
            - r.spans.get("reconstruct", 0.0) for r in reqs)
    return s * 1e3 / n
