"""reconstruct_self_ms_per_frame: the program's own "decode_plans" spans
(libde265_tpu_torch.api._decode_plans) less the spans directly inside
them (stream_setup, pack, upload, frame, sync, download, ...): the part
of the reconstruct bucket no span names, per picture, over the requests
outside the profiled stretch (traced run)."""
from benchmark.program_spans import window


def read(run):
    w = window(run)
    if w is None:
        return None
    spans, n = w
    outer = {s.id: s for s in spans if s.name == "decode_plans"}
    if not outer:
        return None
    ns = sum(s.t1 - s.t0 for s in outer.values()) - sum(
        s.t1 - s.t0 for s in spans if s.parent in outer)
    return ns / 1e6 / n
