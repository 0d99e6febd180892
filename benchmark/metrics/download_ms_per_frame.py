"""download_ms_per_frame: the program's own "download" spans
(libde265_tpu_torch.device_stream.DeviceStreamDecoder._host_planes: host
seconds copying decoded planes back from the card), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "download")
