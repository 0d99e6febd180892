"""enqueue_ms_per_frame: the program's own "frame" spans
(libde265_tpu_torch.frame_program.decode_frame_device: host seconds
enqueueing a frame's launches), per picture,
over the requests outside the profiled stretch (traced run)."""
from benchmark.program_spans import ms_per_picture


def read(run):
    return ms_per_picture(run, "frame")
