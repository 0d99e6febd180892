"""program_pack_ms_per_frame: the program's own "pack" spans
(libde265_tpu_torch.device_stream: host seconds packing plans, the ones
DeviceStreamDecoder.pack_seconds adds up), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "pack")
