"""program_drive_ms_per_frame: the program's own spans of the push API
calls ("api.*", libde265_tpu_torch.api) less its "parse" and
"decode_plans" spans inside them, per picture, over the requests
outside the profiled stretch (traced run): the program's version of
drive_ms_per_frame."""
from benchmark.program_spans import window


def read(run):
    w = window(run)
    if w is None:
        return None
    spans, n = w
    api = [s for s in spans if s.name.startswith("api.")]
    if not api:
        return None
    ns = sum(s.t1 - s.t0 for s in api) - sum(
        s.t1 - s.t0 for s in spans if s.name in ("parse", "decode_plans"))
    return ns / 1e6 / n
