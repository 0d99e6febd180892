"""K2, csrc/mc_filter.cu mc_predict_kernel: the inter prediction of a P
picture, one launch for luma and one for [Cb|Cr] (4:2:0). Counted as
chip_smoke.py's K2 bound counts a call, for a picture in which every
4x4 block is inter-predicted from one list: one table row read per luma
block (256 samples) and one per 2x2 luma blocks for chroma (128), the
per-block grids (mv 16, slot 8, pred flags 8 bytes, the inter mask 1)
read once, the int32 prediction planes written once; 792 multiply-adds
per luma block, 280 per chroma block, 2 operations each. Where some
blocks are intra or rows coincide, the count is above what the launch
needs. In ld4k_light's and gop1080p's P pictures every block is inter
and uni-predicted, and on ld4k_light's first P picture the count equals
chip_smoke's from the real grids."""

KERNEL = "mc_predict_kernel"


def launches(g):
    H, W = g["height"], g["width"]
    n = (H // 4) * (W // 4)
    grids = n * (16 + 8 + 8) + n
    elem = 1 if g["bit_depth"] == 8 else 2
    out = [(n * 256 * elem + grids + H * W * 4, 2 * n * 792)]
    if g["chroma_format_idc"] == 1:
        out.append(((n // 4) * 128 * elem + grids
                    + 2 * (H // 2) * (W // 2) * 4, 2 * n * 280))
    return out
