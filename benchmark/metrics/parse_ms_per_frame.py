"""parse_ms_per_frame: the span around NativeFrontend.parse, per
picture, over the requests outside the profiled stretch (traced run)."""


def read(run):
    reqs = run.unprofiled()
    n = sum(len(r.returned) for r in reqs)
    if not n or not any("parse" in r.spans for r in reqs):
        return None
    return sum(r.spans["parse"] for r in reqs if "parse" in r.spans) \
        * 1e3 / n
