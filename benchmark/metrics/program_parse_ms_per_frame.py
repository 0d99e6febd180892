"""program_parse_ms_per_frame: the program's own "parse" spans
(libde265_tpu_torch.native_frontend.NativeFrontend.parse: the C++ parse
of a segment and its FramePlans), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "parse")
