"""K4, csrc/intra_scan.cu intra_wave_kernel: intra prediction and
reconstruction of an intra picture's TUs as a wavefront over CTB-row
bands, one launch for luma and, at 4:2:0, one for the [Cb|Cr] group.
Counted as chip_smoke.py's K4 bound counts a call, for TUs that tile
each plane once, less the border samples, the TU records and the row
tables (they depend on the TU sizes; left out, the count is below what
the launch needs): each sample's int32 residual read once and its int32
value written once; 10 int32 operations a sample. K4's real floor is its
critical path of dependent TU steps, which this bound does not see."""

KERNEL = "intra_wave_kernel"


def launches(g):
    H, W = g["height"], g["width"]
    groups = [H * W]
    if g["chroma_format_idc"] == 1:
        groups.append(2 * (H // 2) * (W // 2))
    return [(2 * 4 * s, 10 * s) for s in groups]
