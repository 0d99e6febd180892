"""K1, csrc/mc_tables.cu tile_table_kernel: the DPB insert of one decoded
picture into the persistent MC tile tables, one launch for luma (16x16
rows) and, at 4:2:0, one for the interleaved [Cb|Cr] pair (8x8 rows).
Each launch reads its padded int16 planes once and writes one slot of
table rows (every tile of the padded row count, as the table lays them
out). The same CUDA kernel is K5 on the tile-column path, which no cell
of this benchmark drives. Counts copied from chip_smoke.py's K1 bound."""

KERNEL = "tile_table_kernel"
ROWPAD = 8      # tile rows of a slot pad to a multiple of 8


def _rows(n):
    return -(-n // ROWPAD) * ROWPAD


def launches(g):
    H, W = g["height"], g["width"]
    elem = 1 if g["bit_depth"] == 8 else 2
    out = [((H + 32) * (W + 32) * 2
            + _rows((H + 20) // 4) * ((W + 20) // 4) * 16 * 16 * elem, 0)]
    if g["chroma_format_idc"] == 1:
        hc, wc = H // 2, W // 2
        out.append((2 * (hc + 16) * (wc + 16) * 2
                    + _rows((hc + 12) // 4) * ((wc + 12) // 4) * 2 * 8 * 8
                    * elem, 0))
    return out
