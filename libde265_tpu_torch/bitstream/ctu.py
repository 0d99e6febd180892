"""The CTU helpers of libde265_tpu/bitstream/ctu.py that the encoder
stands on (the port keeps its own copies of the host modules and imports
nothing of the JAX package): the sig_coeff_flag 4x4 context map, the
chroma QP mapping, the 4:2:2 chroma intra mode remap, clip3 and the PU
partition geometry.

The CABAC syntax walk of that module (SliceReader) is not copied: the
port's front end is the shared C++ parser in native/, and the encoder
writes syntax (encoder/syntax.py) without reading any back.
"""
from ..plan import (PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN,
                    PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N)


# sig_coeff_flag 4x4 context map (spec 9.3.4.2.5)
CTX_IDX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# chroma QP mapping for ChromaArrayType==1 (spec Table 8-10)
CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)

# 4:2:2 chroma intra mode remap (spec Table 8-23; slice.cc:4240)
MAP_CHROMA_422 = (
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31)


def clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def chroma_qp_from_luma(qp_i, chroma_array_type):
    """spec 8.6.1: map qPi -> qPCb/qPCr for 4:2:0."""
    if chroma_array_type == 1:
        if qp_i < 30:
            return qp_i
        if qp_i > 43:
            return qp_i - 6
        return CHROMA_QP_TABLE[qp_i - 30]
    return min(qp_i, 51)


def part_geometry(part_mode, size):
    """PU rectangles (dx, dy, w, h) for each partition (spec Fig. 3)."""
    s, h, q = size, size // 2, size // 4
    if part_mode == PART_2Nx2N:
        return [(0, 0, s, s)]
    if part_mode == PART_2NxN:
        return [(0, 0, s, h), (0, h, s, h)]
    if part_mode == PART_Nx2N:
        return [(0, 0, h, s), (h, 0, h, s)]
    if part_mode == PART_NxN:
        return [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)]
    if part_mode == PART_2NxnU:
        return [(0, 0, s, q), (0, q, s, s - q)]
    if part_mode == PART_2NxnD:
        return [(0, 0, s, s - q), (0, s - q, s, q)]
    if part_mode == PART_nLx2N:
        return [(0, 0, q, s), (q, 0, s - q, s)]
    if part_mode == PART_nRx2N:
        return [(0, 0, s - q, s), (s - q, 0, q, s)]
    raise ValueError(part_mode)
