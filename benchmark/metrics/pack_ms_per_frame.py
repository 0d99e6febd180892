"""pack_ms_per_frame: the program's DeviceStreamDecoder.pack_seconds
(host seconds packing plans), read off each decoder api._decode_plans
returns, per picture, over the requests outside the profiled stretch
(traced run)."""


def read(run):
    reqs = run.unprofiled()
    n = sum(len(r.returned) for r in reqs)
    if not n or not any("reconstruct" in r.spans for r in reqs):
        return None
    return sum(r.pack_s for r in reqs) * 1e3 / n
