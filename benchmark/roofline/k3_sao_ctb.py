"""K3, csrc/sao_filter.cu sao_ctb_kernel: SAO of one plane from the
per-CTB parameters, one launch per plane. Counted as chip_smoke.py's K3
bound counts a call, less the per-CTB parameter grids (under 1% of the
bytes; left out, the count is below what the launch needs): the int32
plane read once and written once; 12 int32 operations a sample."""

KERNEL = "sao_ctb_kernel"


def launches(g):
    H, W = g["height"], g["width"]
    planes = [H * W]
    if g["chroma_format_idc"] == 1:
        planes += [(H // 2) * (W // 2)] * 2
    return [(2 * 4 * s, 12 * s) for s in planes]
