"""upload_ms_per_frame: the program's own "upload" spans
(libde265_tpu_torch.convert.plan_from_numpy and the blob uploads of
device_stream: host seconds copying packed plans to the card), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "upload")
