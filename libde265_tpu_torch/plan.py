"""Copy of libde265_tpu/plan.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package),
with the TU and PU tables of the hybrid device path's host work
(`tu_table` with its TU_* columns and `gather_coeffs`; `pu_table` with
its PU_* columns).

Decode-plan and per-frame metadata structures.

This is the device-friendly mirror of the reference's per-picture metadata
(`MetaDataArray` grids, libde265/image.h:85-157,221-857) and of
the per-worker coefficient buffers (decctx.h:82-89): the serial bitstream
front-end fills these structure-of-arrays plans; the TPU back-end consumes them
as batched tensors.

Granularities:
  - 4x4 grid ("min TU"): prediction mode, intra modes, QP, flags, cbf
  - 16x16 grid: compressed motion field (for temporal MV prediction)
  - CTB grid: SAO parameters, slice/tile ids
"""
from dataclasses import dataclass, field
from typing import List, Optional
import numpy as np

# prediction modes
MODE_INTER = 0
MODE_INTRA = 1
MODE_SKIP = 2

# part modes
PART_2Nx2N = 0
PART_2NxN = 1
PART_Nx2N = 2
PART_NxN = 3
PART_2NxnU = 4
PART_2NxnD = 5
PART_nLx2N = 6
PART_nRx2N = 7


@dataclass
class TURecord:
    """One transform unit: prediction + residual work item, in z-scan decode
    order. coeffs is a dense (size,size) int16 array or None when cbf=0."""
    cidx: int          # 0=Y, 1=Cb, 2=Cr
    x: int             # position in the plane's own sample units
    y: int
    log2: int
    intra_mode: int    # -1 for inter TUs
    qp: int            # QP' for this plane (final, incl. chroma mapping)
    transform_skip: bool
    tq_bypass: bool
    pred_mode: int     # MODE_INTRA / MODE_INTER
    coeffs: Optional[np.ndarray]
    # cross-component prediction ResScaleVal (range ext) — 0 for Main
    cross_comp_alpha: int = 0
    # explicit RDPCM (range ext): -1 none, 1 horizontal, 2 vertical
    # (matching the reference's residualDpcm, slice.cc:3456-3462)
    explicit_rdpcm: int = -1


@dataclass
class PURecord:
    """One (inter) prediction unit with fully derived motion."""
    x: int
    y: int
    w: int
    h: int
    pred_flag: tuple          # (l0, l1)
    mv: tuple                 # ((mvx0, mvy0), (mvx1, mvy1)) in 1/4-pel
    ref_idx: tuple            # (r0, r1)
    ref_poc: tuple            # POC of references (for metadata/debug)
    ref_dpb: tuple            # DPB slot indices of references


@dataclass
class SAOInfo:
    """Per-CTB SAO parameters, per plane."""
    type_idx: np.ndarray      # (nctbY, nctbX, 3) 0=off,1=band,2=edge
    eo_class: np.ndarray      # (nctbY, nctbX, 3) edge class 0..3
    band_pos: np.ndarray      # (nctbY, nctbX, 3)
    offsets: np.ndarray       # (nctbY, nctbX, 3, 4) int


class FramePlan:
    """All decode state for one picture produced by the front-end."""

    def __init__(self, sps, pps, poc=0):
        self.sps = sps
        self.pps = pps
        self.poc = poc
        W, H = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        self.W, self.H = W, H
        # 4x4 grids (padded up)
        gw, gh = -(-W // 4), -(-H // 4)
        self.gw, self.gh = gw, gh
        self.pred_mode = np.full((gh, gw), MODE_INTRA, np.uint8)
        self.skip_flag = np.zeros((gh, gw), np.uint8)
        self.intra_mode_y = np.full((gh, gw), 255, np.uint8)  # 255 = not intra
        self.intra_mode_c = np.full((gh, gw), 255, np.uint8)
        # chroma mode came from intra_chroma_pred_mode==4 (copy of luma):
        # gates cross-component prediction for intra CUs (range ext,
        # reference image.h is_IntraPredModeC_Mode4 / slice.cc:3678-3683)
        self.intra_cmode4 = np.zeros((gh, gw), np.uint8)
        self.ct_depth = np.zeros((gh, gw), np.uint8)
        self.log2_cb_size = np.zeros((gh, gw), np.uint8)
        self.qp_y = np.zeros((gh, gw), np.int8)
        self.tq_bypass = np.zeros((gh, gw), np.uint8)
        self.pcm_flag = np.zeros((gh, gw), np.uint8)
        self.cbf_luma = np.zeros((gh, gw), np.uint8)   # cbf of the TU covering it
        self.tu_boundary = np.zeros((gh, gw), np.uint8)  # bit0: left edge, bit1: top edge
        self.pb_boundary = np.zeros((gh, gw), np.uint8)
        self.cb_boundary = np.zeros((gh, gw), np.uint8)
        # motion at 4x4 granularity (for spatial neighbors/deblock)
        self.mv = np.zeros((gh, gw, 2, 2), np.int16)       # [list][x/y]
        self.ref_idx = np.full((gh, gw, 2), -1, np.int8)
        self.pred_flag = np.zeros((gh, gw, 2), np.uint8)
        self.ref_poc = np.zeros((gh, gw, 2), np.int32)
        self.ref_lt = np.zeros((gh, gw, 2), np.uint8)
        # per-CTB
        nctbx, nctby = sps.PicWidthInCtbsY, sps.PicHeightInCtbsY
        self.nctbx, self.nctby = nctbx, nctby
        self.slice_addr_rs = np.full((nctby, nctbx), -1, np.int32)
        self.ctb_slice_seg = np.full((nctby, nctbx), -1, np.int32)
        self.sao = SAOInfo(
            type_idx=np.zeros((nctby, nctbx, 3), np.uint8),
            eo_class=np.zeros((nctby, nctbx, 3), np.uint8),
            band_pos=np.zeros((nctby, nctbx, 3), np.uint8),
            offsets=np.zeros((nctby, nctbx, 3, 4), np.int16),
        )
        # work lists in decode order (lazily materialized when the native
        # front-end supplies raw arrays instead)
        self._tus: List[TURecord] = []
        self._pus: List[PURecord] = []
        self._tu_arrays = None   # (tu_meta, coeff_pool, pcm_pool)
        self._pu_arrays = None   # (pu_meta, slice_headers)
        # per-slice info for loop filters / reconstruction
        self.slice_headers = []
        # reconstructed planes (filled by backend)
        self.planes = None  # [Y, Cb, Cr] numpy arrays
        # 16x16 compressed motion field for TMVP of later frames
        mw, mh = -(-W // 16), -(-H // 16)
        self.cmv = np.zeros((mh, mw, 2, 2), np.int16)
        self.cref_idx = np.full((mh, mw, 2), -1, np.int8)
        self.cpred_flag = np.zeros((mh, mw, 2), np.uint8)
        self.cref_poc = np.zeros((mh, mw, 2), np.int32)
        self.cis_long_term = np.zeros((mh, mw, 2), np.uint8)
        self.cintra = np.ones((mh, mw), np.uint8)

    @property
    def tus(self):
        if self._tu_arrays is not None:
            self._materialize_tus()
        return self._tus

    @tus.setter
    def tus(self, v):
        self._tus = v
        self._tu_arrays = None

    @property
    def pus(self):
        if self._pu_arrays is not None:
            self._materialize_pus()
        return self._pus

    @pus.setter
    def pus(self, v):
        self._pus = v
        self._pu_arrays = None

    def _materialize_tus(self):
        tu_meta, coeffs, pcm = self._tu_arrays
        self._tu_arrays = None
        out = []
        for i in range(tu_meta.shape[0]):
            (cidx, x, y, log2, imode, qp, tskip, tqb, pm, coff,
             ccp, rdpcm) = (int(v) for v in tu_meta[i])
            n = 1 << log2
            if cidx == -1:
                tu = TURecord(cidx=-1, x=x, y=y, log2=log2, intra_mode=-1,
                              qp=0, transform_skip=False, tq_bypass=False,
                              pred_mode=MODE_INTRA, coeffs=None)
                ysz = n * n
                # chroma PCM block geometry follows the chroma format
                # (frontend.cc read_pcm); monochrome has none
                if self.sps.ChromaArrayType != 0:
                    cw_, ch_ = n // self.sps.SubWidthC, \
                        n // self.sps.SubHeightC
                else:
                    cw_ = ch_ = 0
                tu.pcm_y = pcm[coff:coff + ysz].reshape(n, n).astype(np.uint16)
                tu.pcm_c = pcm[coff + ysz:coff + ysz + 2 * cw_ * ch_].reshape(
                    2, ch_, cw_).astype(np.uint16)
                out.append(tu)
                continue
            cf = None
            if coff >= 0:
                cf = coeffs[coff:coff + n * n].reshape(n, n).astype(np.int32)
            out.append(TURecord(
                cidx=cidx, x=x, y=y, log2=log2, intra_mode=imode, qp=qp,
                transform_skip=bool(tskip), tq_bypass=bool(tqb),
                pred_mode=pm, coeffs=cf, cross_comp_alpha=ccp,
                explicit_rdpcm=rdpcm))
        self._tus = out

    def _materialize_pus(self):
        pu_meta, shs = self._pu_arrays
        self._pu_arrays = None
        out = []
        for i in range(pu_meta.shape[0]):
            m = [int(v) for v in pu_meta[i]]
            pu = PURecord(
                x=m[0], y=m[1], w=m[2], h=m[3],
                pred_flag=(m[4], m[5]),
                mv=((m[6], m[7]), (m[8], m[9])),
                ref_idx=(m[10], m[11]),
                ref_poc=(m[12], m[13]),
                ref_dpb=(m[14], m[15]))
            pu.slice_header = shs[m[16]]
            out.append(pu)
        self._pus = out

    def compress_motion(self):
        """Subsample the 4x4 motion field to 16x16 (spec: TMVP uses the
        motion of the top-left 4x4 of each 16x16 region)."""
        self.cmv = self.mv[::4, ::4].copy()
        self.cref_idx = self.ref_idx[::4, ::4].copy()
        self.cpred_flag = self.pred_flag[::4, ::4].copy()
        self.cref_poc = self.ref_poc[::4, ::4].copy()
        self.cis_long_term = self.ref_lt[::4, ::4].copy()
        self.cintra = (self.pred_mode[::4, ::4] == MODE_INTRA).astype(np.uint8)


# tu_meta columns: the native front end's TU rows (native_frontend.
# fe_get_tus), as plan._tu_arrays[0] holds them and tu_table gives them
(TU_CIDX, TU_X, TU_Y, TU_LOG2, TU_IMODE, TU_QP, TU_TSKIP, TU_TQB, TU_PM,
 TU_COFF, TU_CCP, TU_RDPCM) = range(12)


def tu_table(plan):
    """(tu_meta (N, 12) int32, coefficient pool int16, PCM pool int16):
    row i is the plan's i-th TU in decode order; TU_COFF is the offset of
    its n*n coefficients in the pool (-1: none), or for a PCM block
    (cidx -1) of its n*n luma and then its two chroma blocks in the PCM
    pool. The native front end's arrays where the plan still holds them,
    else rebuilt from the TURecords (the host work of the hybrid device
    path reads this table instead of looping over TURecords); ValueError
    where a record's value does not fit the int16 pools (a corrupted
    stream's)."""
    if plan._tu_arrays is not None:
        return plan._tu_arrays
    rows, cpool, ppool = [], [], []
    clen = plen = 0
    for tu in plan.tus:
        if tu.cidx == -1:
            blk = np.concatenate([np.asarray(tu.pcm_y).ravel(),
                                  np.asarray(tu.pcm_c).ravel()])
            coff, plen = plen, plen + blk.size
            ppool.append(blk)
        elif tu.coeffs is None:
            coff = -1
        else:
            coff, clen = clen, clen + tu.coeffs.size
            cpool.append(np.asarray(tu.coeffs).ravel())
        rows.append((tu.cidx, tu.x, tu.y, tu.log2, tu.intra_mode, tu.qp,
                     int(tu.transform_skip), int(tu.tq_bypass), tu.pred_mode,
                     coff, tu.cross_comp_alpha, tu.explicit_rdpcm))

    def pool(parts):
        if not parts:
            return np.zeros(1, np.int16)
        p = np.concatenate(parts)
        if p.min() < -32768 or p.max() > 32767:
            raise ValueError("a coefficient or sample outside int16")
        return p.astype(np.int16)
    meta = np.asarray(rows, np.int32).reshape(len(rows), 12)
    return meta, pool(cpool), pool(ppool)


def gather_coeffs(pool, coff, log2):
    """(K, n, n) int32 coefficient blocks at pool offsets coff (K,)."""
    nn = 1 << (2 * log2)
    idx = coff.astype(np.int64)[:, None] + np.arange(nn)[None, :]
    return pool[idx].astype(np.int32).reshape(-1, 1 << log2, 1 << log2)


# pu_meta columns: the native front end's PU rows (native_frontend.
# fe_get_pus), as plan._pu_arrays[0] holds them and pu_table gives them
(PU_X, PU_Y, PU_W, PU_H, PU_PF0, PU_PF1, PU_MV0X, PU_MV0Y, PU_MV1X,
 PU_MV1Y, PU_RIDX0, PU_RIDX1, PU_POC0, PU_POC1, PU_FID0, PU_FID1,
 PU_SLICE) = range(17)


def pu_table(plan):
    """(P, 17) int32 PU rows of the native front end (PU_SLICE indexes
    plan.slice_headers), rebuilt from the PURecords where those were
    materialized."""
    if plan._pu_arrays is not None:
        return plan._pu_arrays[0]
    shs = plan.slice_headers
    rows = [(pu.x, pu.y, pu.w, pu.h, *pu.pred_flag, *pu.mv[0], *pu.mv[1],
             *pu.ref_idx, *pu.ref_poc, *pu.ref_dpb,
             next(i for i, s in enumerate(shs) if s is pu.slice_header))
            for pu in plan.pus]
    return np.asarray(rows, np.int32).reshape(len(rows), 17)


def grey_planes(sps, W, H):
    """Mid-grey concealment planes with format-correct chroma geometry
    and per-component bit-depth dtypes (decctx concealment counterpart)."""
    gy = 1 << (sps.BitDepthY - 1)
    dty = np.uint8 if sps.BitDepthY == 8 else np.uint16
    y = np.full((H, W), gy, dty)
    if sps.ChromaArrayType == 0:
        z = np.zeros((0, 0), dty)
        return [y, z, z]
    gc = 1 << (sps.BitDepthC - 1)
    dtc = np.uint8 if sps.BitDepthC == 8 else np.uint16
    cw, ch = W // sps.SubWidthC, H // sps.SubHeightC
    return [y, np.full((ch, cw), gc, dtc), np.full((ch, cw), gc, dtc)]
