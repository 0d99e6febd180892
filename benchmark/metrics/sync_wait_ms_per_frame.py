"""sync_wait_ms_per_frame: the program's own "sync" spans
(libde265_tpu_torch.api._decode_plans: host seconds waiting for the
card to finish a segment), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "sync")
