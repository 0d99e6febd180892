"""Copy of libde265_tpu/bitstream/ctu.py (the port keeps its own copies
of the host modules and imports nothing of the JAX package).

CTU / CU / TU / residual syntax decoding — the full Main-profile CABAC
syntax walk (spec 7.3.8 + 9.3.4), emitting batched decode-plan records
instead of reconstructing pixels in place. SliceReader is the front end
of the port's per-picture push path (decoder.PictureDecoder,
api.new_decoder(parse="python")); the encoder stands on its helpers
(CTX_IDX_MAP_4x4, the chroma QP mapping, MAP_CHROMA_422, clip3,
part_geometry).

Capability counterpart of libde265/slice.cc:1507-5072
(read_coding_tree_unit, read_coding_quadtree, read_coding_unit,
read_transform_tree/unit, residual_coding, read_sao, decode_substream) —
re-designed so that the serial front-end only touches syntax + metadata
grids, while pixel work is deferred to the device via plan.TURecord /
PURecord.
"""
import numpy as np

from .cabac import CabacDecoder
from . import cabac as cabac_mod
from .contextmodel import ContextModelTable
from .scan import get_scan_order, SCAN_DIAG, SCAN_HORIZ, SCAN_VERT
from ..plan import (FramePlan, TURecord, PURecord,
                    MODE_INTER, MODE_INTRA,
                    PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN,
                    PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N)
from .sliceheader import SLICE_TYPE_I, SLICE_TYPE_P, SLICE_TYPE_B

# sig_coeff_flag 4x4 context map (spec 9.3.4.2.5)
CTX_IDX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# chroma QP mapping for ChromaArrayType==1 (spec Table 8-10)
CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)

# 4:2:2 chroma intra mode remap (spec Table 8-23; slice.cc:4240)
MAP_CHROMA_422 = (
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31)

PRED_L0, PRED_L1, PRED_BI = 0, 1, 2


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


class SliceReader:
    """Decodes one slice segment's CTU data into a FramePlan.

    The outer decoder constructs one SliceReader per slice segment NAL and
    calls decode(). WPP/tile substreams are handled inside (entry points +
    CABAC reinit + WPP context inheritance), mirroring the structure of
    decode_substream (libde265/slice.cc:4664-4830) but purely
    serially — device-side parallelism is applied later in the pipeline.
    """

    def __init__(self, frame: FramePlan, sh, slice_data: bytes, motion=None,
                 wpp_contexts=None, dep_slice_ctx=None):
        self.frame = frame
        self.sps = frame.sps
        self.pps = frame.pps
        self.sh = sh
        self.data = slice_data  # slice segment data, starting at first CABAC byte
        self.motion = motion    # MotionDeriver (None for intra-only)
        # WPP: list (one per CTB row) of saved context tables, shared between
        # slice segments of the same picture
        self.wpp_contexts = wpp_contexts if wpp_contexts is not None else {}
        self.dep_slice_ctx = dep_slice_ctx  # saved ctx table for dependent slices

        self.ctx = ContextModelTable()
        self.cabac = None

        # QP state
        self.qp_y_pred_prev = sh.SliceQPY  # qPY_PREV
        self.cu_qp_delta = 0
        self.is_cu_qp_delta_coded = False
        self.qg_x = 0
        self.qg_y = 0
        self.last_cu_qp = sh.SliceQPY
        self.cur_cu_qp = sh.SliceQPY
        # TU-level chroma QP offsets (range ext, slice.cc:3610-3635)
        self.cu_qp_offset_cb = 0
        self.cu_qp_offset_cr = 0
        self.is_cu_chroma_qp_offset_coded = False

        # geometry shorthands
        self.ctb_log2 = self.sps.Log2CtbSizeY
        self.ctb_size = self.sps.CtbSizeY
        self.min_cb_log2 = self.sps.Log2MinCbSizeY
        self.W = self.sps.pic_width_in_luma_samples
        self.H = self.sps.pic_height_in_luma_samples
        self.pic_w_ctbs = self.sps.PicWidthInCtbsY

        self.end_of_slice = False
        self.saved_ctx_for_dep = None

    # ------------------------------------------------------------------
    # availability (spec 6.4.1), using FramePlan CTB grids
    def available_zscan(self, x_curr, y_curr, x_nb, y_nb):
        if x_nb < 0 or y_nb < 0 or x_nb >= self.W or y_nb >= self.H:
            return False
        pps = self.pps
        W = self.pic_w_ctbs
        log2 = self.ctb_log2
        rs_c = (y_curr >> log2) * W + (x_curr >> log2)
        rs_n = (y_nb >> log2) * W + (x_nb >> log2)
        ts_c = pps.CtbAddrRStoTS[rs_c]
        ts_n = pps.CtbAddrRStoTS[rs_n]
        if ts_n > ts_c:
            return False
        if ts_n == ts_c:
            # z-order comparison within the CTB on the 4x4 grid
            if self._zorder(x_nb, y_nb) >= self._zorder(x_curr, y_curr):
                return False
        # same slice (SliceAddrRS) and same tile
        sa = self.frame.slice_addr_rs
        if sa[rs_n // W, rs_n % W] != sa[rs_c // W, rs_c % W]:
            return False
        if pps.TileId[rs_n] != pps.TileId[rs_c]:
            return False
        return True

    def _zorder(self, x, y):
        xr = (x & (self.ctb_size - 1)) >> 2
        yr = (y & (self.ctb_size - 1)) >> 2
        z = 0
        for b in range(8):
            z |= ((xr >> b) & 1) << (2 * b)
            z |= ((yr >> b) & 1) << (2 * b + 1)
        return z

    # ------------------------------------------------------------------
    def decode(self):
        """Decode the whole slice segment (all substreams)."""
        sh = self.sh
        sps, pps = self.sps, self.pps
        frame = self.frame
        # context init (spec 9.3.2.2; dependent slices restore instead)
        if sh.dependent_slice_segment_flag and self.dep_slice_ctx is not None:
            self.ctx = self.dep_slice_ctx.copy()
        else:
            self.ctx.init_states(sh.initType, clip3(0, 51, sh.SliceQPY))

        ctb_addr_ts = pps.CtbAddrRStoTS[sh.slice_segment_address]
        # substream boundaries from entry points
        offsets = [0]
        for off in sh.entry_point_offsets:
            offsets.append(offsets[-1] + off)
        offsets.append(len(self.data))
        substream = 0
        self.cabac = CabacDecoder(self.data, offsets[0])

        first_ctb = True
        while True:
            ctb_rs = pps.CtbAddrTStoRS[ctb_addr_ts]
            xCtb = (ctb_rs % self.pic_w_ctbs) << self.ctb_log2
            yCtb = (ctb_rs // self.pic_w_ctbs) << self.ctb_log2
            cx, cy = ctb_rs % self.pic_w_ctbs, ctb_rs // self.pic_w_ctbs

            is_tile_start = (ctb_addr_ts == 0 or
                             pps.TileId[ctb_rs] != pps.TileId[pps.CtbAddrTStoRS[ctb_addr_ts - 1]])
            is_row_start = (cx == 0)
            # record slice ids before any availability checks below
            frame.ctb_slice_seg[cy, cx] = sh.slice_segment_address
            frame.slice_addr_rs[cy, cx] = sh.SliceAddrRS

            if not first_ctb:
                if pps.tiles_enabled_flag and is_tile_start:
                    # new tile: next substream + CABAC & context reinit
                    substream += 1
                    self.cabac = CabacDecoder(self.data, offsets[substream])
                    self.ctx.init_states(sh.initType, clip3(0, 51, sh.SliceQPY))
                    self.qp_y_pred_prev = sh.SliceQPY
                    self.last_cu_qp = sh.SliceQPY
                elif pps.entropy_coding_sync_enabled_flag and is_row_start:
                    substream += 1
                    self.cabac = CabacDecoder(self.data, offsets[substream])
                    # WPP context inheritance from CTB(1, row-1), only if the
                    # above-right CTB is available (same slice/tile, spec 9.3.1)
                    saved = self.wpp_contexts.get(cy - 1)
                    ar_ok = self.available_zscan(xCtb, yCtb,
                                                 xCtb + self.ctb_size,
                                                 yCtb - self.ctb_size)                         if yCtb > 0 else False
                    if self.pic_w_ctbs == 1:
                        # 1-CTB-wide picture: the reference re-inits the
                        # models per row (slice.cc:4696-4703); no
                        # snapshot restore at width 1
                        ar_ok = False
                    if saved is not None and ar_ok:
                        self.ctx = saved.copy()
                    else:
                        self.ctx.init_states(sh.initType, clip3(0, 51, sh.SliceQPY))
                    self.qp_y_pred_prev = sh.SliceQPY
                    self.last_cu_qp = sh.SliceQPY
            else:
                if pps.entropy_coding_sync_enabled_flag and is_row_start \
                        and cy > 0:
                    saved = self.wpp_contexts.get(cy - 1)
                    if sh.dependent_slice_segment_flag:
                        # a dependent segment starting at a row start
                        # takes the WPP model of the row above,
                        # OVERRIDING the dependent-continuation ctx
                        # (reference decode_substream slice.cc:4679-4702
                        # restores whenever !first_independent_
                        # substream); adversarial wpp x dep vector (r4).
                        # 1-CTB-wide pictures: the reference re-inits
                        # instead (slice.cc:4696-4703) — no snapshot is
                        # ever stored at width 1.
                        if self.pic_w_ctbs == 1:
                            self.ctx.init_states(
                                sh.initType, clip3(0, 51, sh.SliceQPY))
                        elif saved is not None:
                            self.ctx = saved.copy()
                    elif self.pic_w_ctbs > 1:
                        # first CTB of a new slice at a row start: sync
                        # only if the above-right CTB is available
                        ar_ok = self.available_zscan(
                            xCtb, yCtb, xCtb + self.ctb_size,
                            yCtb - self.ctb_size)
                        if saved is not None and ar_ok:
                            self.ctx = saved.copy()

            # record slice ids
            frame.ctb_slice_seg[cy, cx] = sh.slice_segment_address
            frame.slice_addr_rs[cy, cx] = sh.SliceAddrRS

            # SAO
            if sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag:
                self._read_sao(cx, cy, xCtb, yCtb)

            self._coding_quadtree(xCtb, yCtb, self.ctb_log2, 0)

            # WPP: snapshot contexts after 2nd CTB of row (the reference
            # stores only at ctbx==1, slice.cc:4741-4752 — width-1
            # pictures never snapshot; they re-init per row)
            if pps.entropy_coding_sync_enabled_flag and cx == 1:
                self.wpp_contexts[cy] = self.ctx.copy()

            end_flag = self.cabac.decode_terminate()
            first_ctb = False
            ctb_addr_ts += 1
            if end_flag:
                self.end_of_slice = True
                break
            if ctb_addr_ts >= sps.PicSizeInCtbsY:
                break
            # tile/WPP substream end handling: consume end_of_sub_stream bit
            next_rs = pps.CtbAddrTStoRS[ctb_addr_ts]
            next_tile_start = pps.TileId[next_rs] != pps.TileId[ctb_rs]
            next_row_start = (next_rs % self.pic_w_ctbs) == 0
            if (pps.tiles_enabled_flag and next_tile_start) or \
               (pps.entropy_coding_sync_enabled_flag and next_row_start):
                one = self.cabac.decode_terminate()  # end_of_subset_one_bit
                # byte alignment handled by jumping to next entry point
        # save contexts for a following dependent slice segment
        self.saved_ctx_for_dep = self.ctx.copy()
        return ctb_addr_ts

    # ------------------------------------------------------------------
    def _read_sao(self, cx, cy, xCtb, yCtb):
        """spec 7.3.8.3 sao()."""
        sh, pps, frame = self.sh, self.pps, self.frame
        sao = frame.sao
        merge = False
        rs = cy * self.pic_w_ctbs + cx
        if cx > 0:
            left_avail = self.available_zscan(xCtb, yCtb, xCtb - 1, yCtb)
            if left_avail:
                if self.cabac.decode_bin(self.ctx.at("sao_merge_flag")):
                    sao.type_idx[cy, cx] = sao.type_idx[cy, cx - 1]
                    sao.eo_class[cy, cx] = sao.eo_class[cy, cx - 1]
                    sao.band_pos[cy, cx] = sao.band_pos[cy, cx - 1]
                    sao.offsets[cy, cx] = sao.offsets[cy, cx - 1]
                    merge = True
        if not merge and cy > 0:
            up_avail = self.available_zscan(xCtb, yCtb, xCtb, yCtb - 1)
            if up_avail:
                if self.cabac.decode_bin(self.ctx.at("sao_merge_flag")):
                    sao.type_idx[cy, cx] = sao.type_idx[cy - 1, cx]
                    sao.eo_class[cy, cx] = sao.eo_class[cy - 1, cx]
                    sao.band_pos[cy, cx] = sao.band_pos[cy - 1, cx]
                    sao.offsets[cy, cx] = sao.offsets[cy - 1, cx]
                    merge = True
        if merge:
            return
        for c in range(3):
            if c == 0 and not sh.slice_sao_luma_flag:
                continue
            if c > 0 and not sh.slice_sao_chroma_flag:
                continue
            bitdepth = self.sps.BitDepthY if c == 0 else self.sps.BitDepthC
            if c == 2:
                # type copied from Cb; offsets/class own
                type_idx = sao.type_idx[cy, cx, 1]
            else:
                # sao_type_idx: bin0 ctx, bin1 bypass
                if self.cabac.decode_bin(self.ctx.at("sao_type_idx")):
                    type_idx = 2 if self.cabac.decode_bypass() else 1
                else:
                    type_idx = 0
            sao.type_idx[cy, cx, c] = type_idx
            if type_idx == 0:
                continue
            cmax = (1 << (min(bitdepth, 10) - 5)) - 1
            offs = [self.cabac.decode_tu_bypass(cmax) for _ in range(4)]
            if type_idx == 1:  # band
                for i in range(4):
                    if offs[i] and self.cabac.decode_bypass():
                        offs[i] = -offs[i]
                sao.band_pos[cy, cx, c] = self.cabac.decode_bypass_bits(5)
            else:  # edge
                offs = [offs[0], offs[1], -offs[2], -offs[3]]
                if c == 0:
                    sao.eo_class[cy, cx, 0] = self.cabac.decode_bypass_bits(2)
                elif c == 1:
                    eo = self.cabac.decode_bypass_bits(2)
                    sao.eo_class[cy, cx, 1] = eo
                    sao.eo_class[cy, cx, 2] = eo
            sao.offsets[cy, cx, c] = offs

    # ------------------------------------------------------------------
    def _coding_quadtree(self, x0, y0, log2_size, depth):
        sps, pps, frame = self.sps, self.pps, self.frame
        split = False
        if x0 + (1 << log2_size) <= self.W and y0 + (1 << log2_size) <= self.H \
                and log2_size > self.min_cb_log2:
            # split_cu_flag with neighbor-depth context
            ctx_inc = 0
            if self.available_zscan(x0, y0, x0 - 1, y0):
                if frame.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                    ctx_inc += 1
            if self.available_zscan(x0, y0, x0, y0 - 1):
                if frame.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                    ctx_inc += 1
            split = bool(self.cabac.decode_bin(self.ctx.at("split_cu_flag", ctx_inc)))
        else:
            split = log2_size > self.min_cb_log2

        if pps.cu_qp_delta_enabled_flag and \
                log2_size >= self.ctb_log2 - pps.diff_cu_qp_delta_depth:
            self.is_cu_qp_delta_coded = False
            self.cu_qp_delta = 0
            self.qg_x, self.qg_y = x0, y0
            # qPY_PREV update: QP of last decoded CU (spec 8.6.1)
            self.qp_y_pred_prev = self.last_cu_qp

        # chroma QP offset group (range ext, slice.cc:4621-4624)
        if self.sh.cu_chroma_qp_offset_enabled_flag and \
                log2_size >= self.ctb_log2 - \
                pps.diff_cu_chroma_qp_offset_depth:
            self.is_cu_chroma_qp_offset_coded = False

        if split:
            half = 1 << (log2_size - 1)
            self._coding_quadtree(x0, y0, log2_size - 1, depth + 1)
            if x0 + half < self.W:
                self._coding_quadtree(x0 + half, y0, log2_size - 1, depth + 1)
            if y0 + half < self.H:
                self._coding_quadtree(x0, y0 + half, log2_size - 1, depth + 1)
            if x0 + half < self.W and y0 + half < self.H:
                self._coding_quadtree(x0 + half, y0 + half, log2_size - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2_size, depth)

    # ------------------------------------------------------------------
    def _set_grid(self, arr, x0, y0, size, val):
        g = 4
        arr[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = val

    def _coding_unit(self, x0, y0, log2_size, depth):
        sps, pps, sh, frame = self.sps, self.pps, self.sh, self.frame
        size = 1 << log2_size
        gx, gy = x0 >> 2, y0 >> 2
        gs = size >> 2

        frame.ct_depth[gy:gy + gs, gx:gx + gs] = depth
        frame.log2_cb_size[gy:gy + gs, gx:gx + gs] = log2_size
        frame.cb_boundary[gy:gy + gs, gx:gx + gs] |= 0
        frame.cb_boundary[gy:gy + gs, gx] |= 1      # left edge
        frame.cb_boundary[gy, gx:gx + gs] |= 2      # top edge

        tq_bypass = False
        if pps.transquant_bypass_enable_flag:
            tq_bypass = bool(self.cabac.decode_bin(self.ctx.at("cu_transquant_bypass_flag")))
        frame.tq_bypass[gy:gy + gs, gx:gx + gs] = 1 if tq_bypass else 0
        self.cur_tq_bypass = tq_bypass

        skip = False
        if sh.slice_type != SLICE_TYPE_I:
            ctx_inc = 0
            if self.available_zscan(x0, y0, x0 - 1, y0) and frame.skip_flag[gy, gx - 1]:
                ctx_inc += 1
            if self.available_zscan(x0, y0, x0, y0 - 1) and frame.skip_flag[gy - 1, gx]:
                ctx_inc += 1
            skip = bool(self.cabac.decode_bin(self.ctx.at("cu_skip_flag", ctx_inc)))
        frame.skip_flag[gy:gy + gs, gx:gx + gs] = 1 if skip else 0

        # derive current CU QP (may be updated when cu_qp_delta decoded)
        self._derive_cu_qp(x0, y0)
        frame.qp_y[gy:gy + gs, gx:gx + gs] = self.cur_cu_qp
        self.cur_cu = (x0, y0, log2_size)

        if skip:
            frame.pred_mode[gy:gy + gs, gx:gx + gs] = MODE_INTER
            self._prediction_unit(x0, y0, x0, y0, size, size, skip=True,
                                  part_idx=0, n_parts=1, ct_depth=depth)
            self.last_cu_qp = self.cur_cu_qp
            return

        pred_mode = MODE_INTRA
        if sh.slice_type != SLICE_TYPE_I:
            pred_mode = MODE_INTRA if self.cabac.decode_bin(self.ctx.at("pred_mode_flag")) \
                else MODE_INTER
        frame.pred_mode[gy:gy + gs, gx:gx + gs] = pred_mode

        part_mode = PART_2Nx2N
        if pred_mode != MODE_INTRA or log2_size == self.min_cb_log2:
            if pred_mode == MODE_INTRA:
                if log2_size == self.min_cb_log2:
                    bin0 = self.cabac.decode_bin(self.ctx.at("part_mode", 0))
                    part_mode = PART_2Nx2N if bin0 else PART_NxN
            else:
                part_mode = self._decode_part_mode_inter(log2_size)

        pcm = False
        if pred_mode == MODE_INTRA:
            if part_mode == PART_2Nx2N and sps.pcm_enabled_flag and \
                    log2_size >= sps.log2_min_pcm_luma_coding_block_size and \
                    log2_size <= (sps.log2_min_pcm_luma_coding_block_size +
                                  sps.log2_diff_max_min_pcm_luma_coding_block_size):
                pcm = bool(self.cabac.decode_terminate())
            if pcm:
                frame.pcm_flag[gy:gy + gs, gx:gx + gs] = 1
                self._read_pcm_samples(x0, y0, log2_size)
                self.last_cu_qp = self.cur_cu_qp
                return
            self._intra_pred_info(x0, y0, log2_size, part_mode)
        else:
            self._inter_pred_info(x0, y0, log2_size, part_mode, depth)

        # transform tree
        rqt_root_cbf = True
        if pred_mode != MODE_INTRA and not (part_mode == PART_2Nx2N and self.merge_2nx2n):
            rqt_root_cbf = bool(self.cabac.decode_bin(self.ctx.at("rqt_root_cbf")))
        if rqt_root_cbf:
            intra_split = 1 if (pred_mode == MODE_INTRA and part_mode == PART_NxN) else 0
            if pred_mode == MODE_INTRA:
                max_depth = sps.max_transform_hierarchy_depth_intra + intra_split
            else:
                max_depth = sps.max_transform_hierarchy_depth_inter
            self.cur_pred_mode = pred_mode
            self.cur_part_mode = part_mode
            self.cur_intra_split = intra_split
            self.cur_log2_cb = log2_size
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0, max_depth,
                                 parent_cbf_cb=True, parent_cbf_cr=True)
        else:
            # no residual at all; still need chroma/luma prediction records for
            # inter CUs? inter prediction is PU-driven, nothing to emit.
            pass
        self.last_cu_qp = self.cur_cu_qp

    # ------------------------------------------------------------------
    def _decode_part_mode_inter(self, log2_size):
        c = self.cabac
        if c.decode_bin(self.ctx.at("part_mode", 0)):
            return PART_2Nx2N
        if log2_size > self.min_cb_log2:
            amp = self.sps.amp_enabled_flag
            bin1 = c.decode_bin(self.ctx.at("part_mode", 1))
            if not amp:
                return PART_2NxN if bin1 else PART_Nx2N
            bin2 = c.decode_bin(self.ctx.at("part_mode", 3))
            if bin1:
                if bin2:
                    return PART_2NxN
                return PART_2NxnD if c.decode_bypass() else PART_2NxnU
            else:
                if bin2:
                    return PART_Nx2N
                return PART_nRx2N if c.decode_bypass() else PART_nLx2N
        else:
            bin1 = c.decode_bin(self.ctx.at("part_mode", 1))
            if bin1:
                return PART_2NxN
            if log2_size == 3:
                return PART_Nx2N
            bin2 = c.decode_bin(self.ctx.at("part_mode", 2))
            return PART_Nx2N if bin2 else PART_NxN

    # ------------------------------------------------------------------
    def _derive_cu_qp(self, x0, y0):
        """spec 8.6.1 luma QP prediction."""
        sps, pps, frame = self.sps, self.pps, self.frame
        if not pps.cu_qp_delta_enabled_flag:
            self.cur_cu_qp = self.sh.SliceQPY
            return
        xQg, yQg = self.qg_x, self.qg_y
        qp_prev = self.qp_y_pred_prev
        ctb_mask = self.ctb_size - 1
        # left
        if self.available_zscan(xQg, yQg, xQg - 1, yQg) and \
                ((xQg - 1) >> self.ctb_log2 == xQg >> self.ctb_log2) and \
                ((yQg) >> self.ctb_log2 == yQg >> self.ctb_log2):
            qp_a = int(frame.qp_y[yQg >> 2, (xQg - 1) >> 2])
        else:
            qp_a = qp_prev
        # above
        if self.available_zscan(xQg, yQg, xQg, yQg - 1) and \
                ((yQg - 1) >> self.ctb_log2 == yQg >> self.ctb_log2):
            qp_b = int(frame.qp_y[(yQg - 1) >> 2, xQg >> 2])
        else:
            qp_b = qp_prev
        qp_pred = (qp_a + qp_b + 1) >> 1
        off = sps.QpBdOffsetY
        self.cur_cu_qp = ((qp_pred + self.cu_qp_delta + 52 + 2 * off) %
                          (52 + off)) - off

    # ------------------------------------------------------------------
    def _intra_pred_info(self, x0, y0, log2_size, part_mode):
        frame = self.frame
        c = self.cabac
        n_parts = 4 if part_mode == PART_NxN else 1
        pb_size = (1 << log2_size) >> (1 if n_parts == 4 else 0)
        prev_flags = [c.decode_bin(self.ctx.at("prev_intra_luma_pred_flag"))
                      for _ in range(n_parts)]
        mpm_or_rem = []
        for i in range(n_parts):
            if prev_flags[i]:
                mpm_or_rem.append(c.decode_tu_bypass(2))  # mpm_idx
            else:
                mpm_or_rem.append(c.decode_bypass_bits(5))  # rem_intra_luma_pred_mode
        modes = []
        for i in range(n_parts):
            px = x0 + (i & 1) * pb_size
            py = y0 + (i >> 1) * pb_size
            mode = self._derive_intra_mode(px, py, prev_flags[i], mpm_or_rem[i])
            modes.append(mode)
            frame.intra_mode_y[py >> 2:(py + pb_size) >> 2,
                               px >> 2:(px + pb_size) >> 2] = mode
        # chroma mode: one per CU (4:2:0/4:2:2) or one per PB (4:4:4,
        # slice.cc:4447-4470); 4:2:2 remaps through Table 8-23
        cat = self.sps.ChromaArrayType

        def read_cmode(luma_mode):
            if c.decode_bin(self.ctx.at("intra_chroma_pred_mode")):
                idx = c.decode_bypass_bits(2)
                cand = (0, 26, 10, 1)[idx]
                cmode = 34 if cand == luma_mode else cand
                self._last_cmode4 = False
            else:
                cmode = luma_mode
                self._last_cmode4 = True   # mode 4: copy of luma
            if cat == 2:
                cmode = MAP_CHROMA_422[cmode]
            return cmode

        if cat == 3:
            for i in range(n_parts):
                px = x0 + (i & 1) * pb_size
                py = y0 + (i >> 1) * pb_size
                frame.intra_mode_c[py >> 2:(py + pb_size) >> 2,
                                   px >> 2:(px + pb_size) >> 2] = \
                    read_cmode(modes[i])
                frame.intra_cmode4[py >> 2:(py + pb_size) >> 2,
                                   px >> 2:(px + pb_size) >> 2] = \
                    1 if self._last_cmode4 else 0
        elif cat != 0:
            cmode = read_cmode(modes[0])
            size = 1 << log2_size
            frame.intra_mode_c[y0 >> 2:(y0 + size) >> 2,
                               x0 >> 2:(x0 + size) >> 2] = cmode

    def _derive_intra_mode(self, x, y, prev_flag, val):
        """spec 8.4.2 MPM derivation."""
        frame = self.frame
        def neigh_mode(nx, ny, require_same_ctb_row=False):
            if not self.available_zscan(x, y, nx, ny):
                return 1  # INTRA_DC
            if require_same_ctb_row and (ny >> self.ctb_log2) != (y >> self.ctb_log2):
                return 1
            if frame.pred_mode[ny >> 2, nx >> 2] != MODE_INTRA or \
                    frame.pcm_flag[ny >> 2, nx >> 2]:
                return 1
            return int(frame.intra_mode_y[ny >> 2, nx >> 2])
        cand_a = neigh_mode(x - 1, y)
        cand_b = neigh_mode(x, y - 1, require_same_ctb_row=True)
        if cand_a == cand_b:
            if cand_a < 2:
                mpm = [0, 1, 26]
            else:
                mpm = [cand_a,
                       2 + ((cand_a + 29) % 32),
                       2 + ((cand_a - 2 + 1) % 32)]
        else:
            mpm = [cand_a, cand_b, 0]
            if cand_a != 0 and cand_b != 0:
                mpm[2] = 0
            elif cand_a + cand_b < 2:
                mpm[2] = 26
            else:
                mpm[2] = 1
        if prev_flag:
            return mpm[val]
        m = sorted(mpm)
        mode = val
        for cm in m:
            if mode >= cm:
                mode += 1
        return mode

    # ------------------------------------------------------------------
    def _read_pcm_samples(self, x0, y0, log2_size):
        """spec 7.3.8.7: byte-align, raw samples, CABAC reinit."""
        sps, frame = self.sps, self.frame
        c = self.cabac
        # flush CABAC: position is bytepos; spec aligns to byte boundary
        if c.bitcnt:
            c.bitcnt = 0
            c.bytepos += 1
        size = 1 << log2_size
        nbits_y = sps.pcm_sample_bit_depth_luma
        nbits_c = sps.pcm_sample_bit_depth_chroma
        shift_y = sps.BitDepthY - nbits_y
        shift_c = sps.BitDepthC - nbits_c
        br_pos = c.bytepos * 8
        data = c.data

        def read_bits(pos, n):
            v = 0
            for _ in range(n):
                byte = data[pos >> 3] if (pos >> 3) < len(data) else 0
                v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
                pos += 1
            return v, pos
        ysamples = np.zeros((size, size), np.uint16)
        pos = br_pos
        for yy in range(size):
            for xx in range(size):
                v, pos = read_bits(pos, nbits_y)
                ysamples[yy, xx] = v << shift_y
        cw, chh = size // sps.SubWidthC, size // sps.SubHeightC
        csamples = np.zeros((2, chh, cw), np.uint16)
        if sps.ChromaArrayType != 0:
            for ci in range(2):
                for yy in range(chh):
                    for xx in range(cw):
                        v, pos = read_bits(pos, nbits_c)
                        csamples[ci, yy, xx] = v << shift_c
        # stash as a special TU record (pcm paste)
        self.frame.tus.append(TURecord(
            cidx=-1, x=x0, y=y0, log2=log2_size, intra_mode=-1,
            qp=0, transform_skip=False, tq_bypass=False,
            pred_mode=MODE_INTRA, coeffs=None))
        self.frame.tus[-1].pcm_y = ysamples
        self.frame.tus[-1].pcm_c = csamples
        # restart CABAC after the raw samples
        c.bytepos = (pos + 7) >> 3
        c.bitcnt = 0
        c.range = 510
        c.offset = 0
        for _ in range(9):
            c.offset = (c.offset << 1) | c.read_bit()

    # ------------------------------------------------------------------
    def _inter_pred_info(self, x0, y0, log2_size, part_mode, ct_depth):
        size = 1 << log2_size
        self.merge_2nx2n = False
        parts = part_geometry(part_mode, size)
        for i, (dx, dy, w, h) in enumerate(parts):
            self._prediction_unit(x0, y0, x0 + dx, y0 + dy, w, h, skip=False,
                                  part_idx=i, n_parts=len(parts), ct_depth=ct_depth,
                                  part_mode=part_mode)

    def _prediction_unit(self, xC, yC, x0, y0, w, h, skip, part_idx, n_parts,
                         ct_depth, part_mode=PART_2Nx2N):
        sh, c = self.sh, self.cabac
        merge_idx = 0
        merge = True
        if skip:
            if sh.MaxNumMergeCand > 1:
                merge_idx = self._decode_merge_idx()
            if part_idx == 0 and n_parts == 1:
                self.merge_2nx2n = True
        else:
            merge = bool(c.decode_bin(self.ctx.at("merge_flag")))
            if merge:
                if part_mode == PART_2Nx2N and part_idx == 0:
                    self.merge_2nx2n = True
                if sh.MaxNumMergeCand > 1:
                    merge_idx = self._decode_merge_idx()
        if merge:
            self.motion.decode_merge(self, xC, yC, x0, y0, w, h, part_idx,
                                     part_mode, ct_depth, merge_idx)
            return
        # explicit motion
        inter_pred_idc = PRED_L0
        if sh.slice_type == SLICE_TYPE_B:
            inter_pred_idc = self._decode_inter_pred_idc(w, h, ct_depth)
        mvd = [(0, 0), (0, 0)]
        ref_idx = [0, 0]
        mvp_flag = [0, 0]
        if inter_pred_idc != PRED_L1:
            if sh.num_ref_idx_l0_active > 1:
                ref_idx[0] = self._decode_ref_idx(sh.num_ref_idx_l0_active)
            mvd[0] = self._decode_mvd()
            mvp_flag[0] = c.decode_bin(self.ctx.at("mvp_flag"))
        if inter_pred_idc != PRED_L0:
            if sh.num_ref_idx_l1_active > 1:
                ref_idx[1] = self._decode_ref_idx(sh.num_ref_idx_l1_active)
            if sh.mvd_l1_zero_flag and inter_pred_idc == PRED_BI:
                mvd[1] = (0, 0)
            else:
                mvd[1] = self._decode_mvd()
            mvp_flag[1] = c.decode_bin(self.ctx.at("mvp_flag"))
        self.motion.decode_amvp(self, xC, yC, x0, y0, w, h, part_idx, part_mode,
                                ct_depth, inter_pred_idc, ref_idx, mvd, mvp_flag)

    def _decode_merge_idx(self):
        c = self.cabac
        if not c.decode_bin(self.ctx.at("merge_idx")):
            return 0
        # remaining bins bypass, TR cMax = MaxNumMergeCand-1
        idx = 1
        while idx < self.sh.MaxNumMergeCand - 1 and c.decode_bypass():
            idx += 1
        return idx

    def _decode_inter_pred_idc(self, w, h, ct_depth):
        c = self.cabac
        if w + h != 12:
            if c.decode_bin(self.ctx.at("inter_pred_idc", ct_depth)):
                return PRED_BI
        return PRED_L1 if c.decode_bin(self.ctx.at("inter_pred_idc", 4)) else PRED_L0

    def _decode_ref_idx(self, num_active):
        c = self.cabac
        if not c.decode_bin(self.ctx.at("ref_idx", 0)):
            return 0
        if num_active == 2 or not c.decode_bin(self.ctx.at("ref_idx", 1)):
            return 1
        idx = 2
        while idx < num_active - 1 and c.decode_bypass():
            idx += 1
        return idx

    def _decode_mvd(self):
        """spec 7.3.8.9 mvd_coding."""
        c = self.cabac
        gt0 = [c.decode_bin(self.ctx.at("abs_mvd_greater_flag", 0)) for _ in range(2)]
        gt1 = [0, 0]
        for i in range(2):
            if gt0[i]:
                gt1[i] = c.decode_bin(self.ctx.at("abs_mvd_greater_flag", 1))
        mvd = [0, 0]
        for i in range(2):
            if gt0[i]:
                v = 1
                if gt1[i]:
                    v = 2 + c.decode_eg_bypass(1)
                if c.decode_bypass():  # sign
                    v = -v
                mvd[i] = v
        return (mvd[0], mvd[1])

    # ------------------------------------------------------------------
    def _transform_tree(self, x0, y0, xBase, yBase, log2_size, depth, blk_idx,
                        max_depth, parent_cbf_cb, parent_cbf_cr):
        sps, pps, c, frame = self.sps, self.pps, self.cabac, self.frame
        intra_split = self.cur_intra_split
        inter_split = (sps.max_transform_hierarchy_depth_inter == 0 and
                       self.cur_pred_mode == MODE_INTER and
                       self.cur_part_mode != PART_2Nx2N and depth == 0)
        if log2_size <= sps.Log2MaxTrafoSize and log2_size > sps.Log2MinTrafoSize \
                and depth < max_depth and not (intra_split and depth == 0):
            split = bool(c.decode_bin(self.ctx.at("split_transform_flag", 5 - log2_size)))
        else:
            split = (log2_size > sps.Log2MaxTrafoSize or
                     (intra_split and depth == 0) or inter_split)

        # cbf_cb/cbf_cr are BIT MASKS: bit0 = (top) TB, bit1 = bottom TB
        # (4:2:2 codes two square chroma TBs per luma TB — the second
        # flag is present at non-split nodes and at log2==3 splits;
        # slice.cc:3884-3902)
        cat = sps.ChromaArrayType
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if (log2_size > 2 and cat != 0) or cat == 3:
            two = cat == 2 and (not split or log2_size == 3)
            if depth == 0 or parent_cbf_cb:
                cbf_cb = c.decode_bin(self.ctx.at("cbf_chroma", depth))
                if two:
                    cbf_cb |= c.decode_bin(
                        self.ctx.at("cbf_chroma", depth)) << 1
            else:
                cbf_cb = 0
            if depth == 0 or parent_cbf_cr:
                cbf_cr = c.decode_bin(self.ctx.at("cbf_chroma", depth))
                if two:
                    cbf_cr |= c.decode_bin(
                        self.ctx.at("cbf_chroma", depth)) << 1
            else:
                cbf_cr = 0
        elif cat == 0:
            cbf_cb = cbf_cr = 0

        if split:
            half = 1 << (log2_size - 1)
            self._transform_tree(x0, y0, x0, y0, log2_size - 1, depth + 1, 0,
                                 max_depth, cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0, x0, y0, log2_size - 1, depth + 1, 1,
                                 max_depth, cbf_cb, cbf_cr)
            self._transform_tree(x0, y0 + half, x0, y0, log2_size - 1, depth + 1, 2,
                                 max_depth, cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0 + half, x0, y0, log2_size - 1,
                                 depth + 1, 3, max_depth, cbf_cb, cbf_cr)
            return

        # leaf: cbf_luma
        if self.cur_pred_mode == MODE_INTRA or depth != 0 or cbf_cb or cbf_cr:
            cbf_luma = bool(c.decode_bin(
                self.ctx.at("cbf_luma", 1 if depth == 0 else 0)))
        else:
            cbf_luma = True
        self._transform_unit(x0, y0, xBase, yBase, log2_size, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    # ------------------------------------------------------------------
    def _transform_unit(self, x0, y0, xBase, yBase, log2_size, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr):
        sps, pps, sh, c, frame = self.sps, self.pps, self.sh, self.cabac, self.frame
        size = 1 << log2_size
        gx, gy, gs = x0 >> 2, y0 >> 2, size >> 2
        frame.tu_boundary[gy:gy + gs, gx] |= 1
        frame.tu_boundary[gy, gx:gx + gs] |= 2
        frame.cbf_luma[gy:gy + gs, gx:gx + gs] = 1 if cbf_luma else 0

        cat = sps.ChromaArrayType
        chroma_here = (cat == 3) or (cat != 0 and
                                     (log2_size > 2 or blk_idx == 3))
        # qp-delta presence tests the RAW cbf masks (slice.cc:3583), not
        # whether this leaf carries the chroma TBs
        if cbf_luma or cbf_cb or cbf_cr:
            if pps.cu_qp_delta_enabled_flag and not self.is_cu_qp_delta_coded:
                self._decode_cu_qp_delta()
            # TU-level chroma QP offset (range ext, slice.cc:3610-3635).
            # NOTE the reference reads cu_chroma_qp_offset_idx as ONE bin
            # regardless of list length (slice.cc:3621-3624) — mirrored
            # here; the spec's TR binarization only differs for len>2.
            if sh.cu_chroma_qp_offset_enabled_flag and (cbf_cb or cbf_cr) \
                    and not self.cur_tq_bypass \
                    and not self.is_cu_chroma_qp_offset_coded:
                c_ = self.cabac
                flag = c_.decode_bin(self.ctx.at("cu_chroma_qp_offset_flag"))
                idx = 0
                if flag and len(pps.cb_qp_offset_list) > 1:
                    idx = c_.decode_bin(
                        self.ctx.at("cu_chroma_qp_offset_idx"))
                self.is_cu_chroma_qp_offset_coded = True
                if flag:
                    self.cu_qp_offset_cb = pps.cb_qp_offset_list[idx]
                    self.cu_qp_offset_cr = pps.cr_qp_offset_list[idx]
                else:
                    self.cu_qp_offset_cb = 0
                    self.cu_qp_offset_cr = 0

        qp_prime = self.cur_cu_qp + sps.QpBdOffsetY  # QP' luma (spec 8.6.1)

        # luma TU record (prediction always needed for intra; residual if cbf)
        coeffs = None
        self._last_rdpcm = -1
        if cbf_luma:
            coeffs = self._residual_coding(x0, y0, log2_size, 0)
        intra_mode = int(frame.intra_mode_y[gy, gx]) \
            if self.cur_pred_mode == MODE_INTRA else -1
        ts_flag = getattr(self, "_last_ts_flag", False)
        frame.tus.append(TURecord(
            cidx=0, x=x0, y=y0, log2=log2_size, intra_mode=intra_mode,
            qp=qp_prime, transform_skip=(coeffs is not None and ts_flag),
            tq_bypass=self.cur_tq_bypass, pred_mode=self.cur_pred_mode,
            coeffs=coeffs,
            explicit_rdpcm=(self._last_rdpcm if coeffs is not None else -1)))

        if chroma_here:
            sw, sh_ = sps.SubWidthC, sps.SubHeightC
            if cat == 3:
                lx, ly, clog2 = x0, y0, log2_size
            elif log2_size > 2:
                lx, ly, clog2 = x0, y0, log2_size - 1
            else:
                lx, ly, clog2 = xBase, yBase, 2
            cx, cy_ = lx // sw, ly // sh_
            cmode = int(frame.intra_mode_c[ly >> 2, lx >> 2]) \
                if self.cur_pred_mode == MODE_INTRA else -1
            # 4:2:2: each luma TB carries TWO stacked square chroma TBs
            # (slice.cc:3671-3712); cbf masks select per-TB residuals
            n_tb = 2 if cat == 2 else 1
            # cross-component prediction (range ext, 4:4:4 only):
            # one (scale, sign) pair read per chroma component, before
            # its residual, gated on cbf_luma and inter / chroma-mode-4
            # (slice.cc:3678-3692, 3530-3558)
            do_ccp = (cat == 3 and
                      pps.cross_component_prediction_enabled_flag and
                      bool(cbf_luma) and
                      (self.cur_pred_mode != MODE_INTRA or
                       bool(frame.intra_cmode4[y0 >> 2, x0 >> 2])))
            for ci, cbf in ((1, cbf_cb), (2, cbf_cr)):
                res_scale = 0
                if do_ccp:
                    c_ = self.cabac
                    v = 0
                    for b in range(4):
                        if c_.decode_bin(self.ctx.at(
                                "log2_res_scale_abs_plus1",
                                4 * (ci - 1) + b)):
                            v += 1
                        else:
                            break
                    if v:
                        sgn = c_.decode_bin(self.ctx.at(
                            "res_scale_sign_flag", ci - 1))
                        res_scale = (1 << (v - 1)) * (1 - 2 * sgn)
                for tb in range(n_tb):
                    yoff = tb << clog2
                    ccoeffs = None
                    self._last_rdpcm = -1
                    if cbf & (1 << tb):
                        ccoeffs = self._residual_coding(
                            cx, cy_ + yoff, clog2, ci)
                    cqp = self._chroma_qp(ci)
                    cts = getattr(self, "_last_ts_flag", False)
                    frame.tus.append(TURecord(
                        cidx=ci, x=cx, y=cy_ + yoff, log2=clog2,
                        intra_mode=cmode, qp=cqp,
                        transform_skip=(ccoeffs is not None and cts),
                        tq_bypass=self.cur_tq_bypass,
                        pred_mode=self.cur_pred_mode, coeffs=ccoeffs,
                        cross_comp_alpha=res_scale,
                        explicit_rdpcm=(self._last_rdpcm
                                        if ccoeffs is not None else -1)))

    def _chroma_qp(self, cidx):
        sps, pps, sh = self.sps, self.pps, self.sh
        off = (pps.pic_cb_qp_offset + sh.slice_cb_qp_offset +
               self.cu_qp_offset_cb) if cidx == 1 else \
            (pps.pic_cr_qp_offset + sh.slice_cr_qp_offset +
             self.cu_qp_offset_cr)
        qpi = clip3(-sps.QpBdOffsetC, 57, self.cur_cu_qp + off)
        return chroma_qp_from_luma(qpi, sps.ChromaArrayType) + sps.QpBdOffsetC

    def _decode_cu_qp_delta(self):
        c = self.cabac
        # cu_qp_delta_abs: TU prefix cMax 5 (bin0 ctx0, bins1-4 ctx1) + EG0 suffix
        prefix = 0
        if c.decode_bin(self.ctx.at("cu_qp_delta_abs", 0)):
            prefix = 1
            while prefix < 5 and c.decode_bin(self.ctx.at("cu_qp_delta_abs", 1)):
                prefix += 1
        val = prefix
        if prefix == 5:
            val = 5 + c.decode_eg_bypass(0)
        if val > 0:
            if c.decode_bypass():
                val = -val
        self.cu_qp_delta = val
        self.is_cu_qp_delta_coded = True
        # re-derive the CU QP with the delta and update grids of current CU
        self._derive_cu_qp(*self.cur_cu[:2])
        x0, y0, log2 = self.cur_cu
        gs = (1 << log2) >> 2
        self.frame.qp_y[y0 >> 2:(y0 >> 2) + gs, x0 >> 2:(x0 >> 2) + gs] = self.cur_cu_qp

    # ------------------------------------------------------------------
    def _residual_coding(self, x0, y0, log2_size, cidx):
        """spec 7.3.8.11: returns dense (size,size) int32 coefficient array."""
        sps, pps, sh, c = self.sps, self.pps, self.sh, self.cabac
        size = 1 << log2_size
        self._last_ts_flag = False

        if pps.transform_skip_enabled_flag and not self.cur_tq_bypass and \
                log2_size <= pps.log2_max_transform_skip_block_size:
            self._last_ts_flag = bool(c.decode_bin(
                self.ctx.at("transform_skip_flag", 0 if cidx == 0 else 1)))

        # explicit RDPCM (range ext): inter CUs with tskip/bypass residual
        # (reference residual_coding, slice.cc:2937-2951)
        self._last_rdpcm = -1
        if self.cur_pred_mode == MODE_INTER and \
                sps.explicit_rdpcm_enabled_flag and \
                (self._last_ts_flag or self.cur_tq_bypass):
            if c.decode_bin(self.ctx.at("explicit_rdpcm_flag",
                                        0 if cidx == 0 else 1)):
                d = c.decode_bin(self.ctx.at("explicit_rdpcm_dir_flag",
                                             0 if cidx == 0 else 1))
                self._last_rdpcm = 2 if d else 1

        # persistent Rice adaptation state class (slice.cc:2957-2961)
        sb_type = (2 if cidx == 0 else 0) + \
            (1 if (self._last_ts_flag or self.cur_tq_bypass) else 0)
        persistent = bool(sps.persistent_rice_adaptation_enabled_flag)
        ts_ctx = bool(sps.transform_skip_context_enabled_flag) and \
            (self.cur_tq_bypass or self._last_ts_flag)

        # scan index (spec 7.4.9.11)
        scan_idx = SCAN_DIAG
        if self.cur_pred_mode == MODE_INTRA and \
                (log2_size == 2 or (log2_size == 3 and cidx == 0) or
                 (log2_size == 3 and sps.ChromaArrayType == 3)):
            pred_mode = int(self.frame.intra_mode_y[y0 >> 2, x0 >> 2]) \
                if cidx == 0 else int(self.frame.intra_mode_c[
                    (y0 * sps.SubHeightC) >> 2, (x0 * sps.SubWidthC) >> 2])
            if 6 <= pred_mode <= 14:
                scan_idx = SCAN_VERT
            elif 22 <= pred_mode <= 30:
                scan_idx = SCAN_HORIZ

        # last significant coefficient position (9.3.4.2.3)
        if cidx == 0:
            ctx_off, ctx_shift = 3 * (log2_size - 2) + ((log2_size - 1) >> 2), \
                (log2_size + 1) >> 2
            base_x = self.ctx.at  # noqa
        else:
            ctx_off, ctx_shift = 15, log2_size - 2
        lastx = self._decode_last_prefix("last_sig_coeff_x_prefix", log2_size,
                                         ctx_off, ctx_shift)
        lasty = self._decode_last_prefix("last_sig_coeff_y_prefix", log2_size,
                                         ctx_off, ctx_shift)
        if lastx > 3:
            nbits = (lastx >> 1) - 1
            lastx = ((2 + (lastx & 1)) << nbits) + c.decode_bypass_bits(nbits)
        if lasty > 3:
            nbits = (lasty >> 1) - 1
            lasty = ((2 + (lasty & 1)) << nbits) + c.decode_bypass_bits(nbits)
        if scan_idx == SCAN_VERT:
            lastx, lasty = lasty, lastx

        sb_scan = get_scan_order(size >> 2, scan_idx)
        c_scan = get_scan_order(4, scan_idx)
        sb_index = {p: i for i, p in enumerate(sb_scan)}
        c_index = {p: i for i, p in enumerate(c_scan)}
        last_sb = sb_index[(lastx >> 2, lasty >> 2)]
        last_pos = c_index[(lastx & 3, lasty & 3)]

        nsb = size >> 2
        csbf = np.zeros((nsb, nsb), np.uint8)
        coeffs = np.zeros((size, size), np.int32)

        sign_hiding = bool(pps.sign_data_hiding_flag) and not self.cur_tq_bypass
        prev_greater1_ctx_zero = False  # "lastGreater1Flag" carry between subblocks

        for i in range(last_sb, -1, -1):
            xS, yS = sb_scan[i]
            infer_sb_dc = False
            if i < last_sb and i > 0:
                right = csbf[yS, xS + 1] if xS + 1 < nsb else 0
                below = csbf[yS + 1, xS] if yS + 1 < nsb else 0
                ctx_inc = min(right + below, 1) + (2 if cidx else 0)
                sb_flag = c.decode_bin(self.ctx.at("coded_sub_block_flag", ctx_inc))
                csbf[yS, xS] = sb_flag
                infer_sb_dc = True
                if not sb_flag:
                    continue
            else:
                csbf[yS, xS] = 1

            # significant_coeff_flags
            cabac_mod.TRACE_LABEL[0] = f"sig i={i}"
            sig_pos = []
            start = last_pos - 1 if i == last_sb else 15
            if i == last_sb:
                sig_pos.append(last_pos)
            for n in range(start, -1, -1):
                xP, yP = c_scan[n]
                xC, yC = (xS << 2) + xP, (yS << 2) + yP
                if n == 0 and infer_sb_dc and not sig_pos:
                    # all others zero: DC inferred significant
                    sig_pos.append(0)
                    continue
                if n == 0 and infer_sb_dc and sig_pos:
                    pass  # decode normally below
                ctx_inc = (42 if cidx == 0 else 43) if ts_ctx else \
                    self._sig_ctx(xC, yC, xS, yS, log2_size, cidx,
                                  scan_idx, csbf, nsb)
                cabac_mod.TRACE_LABEL[0] = f"sigctx={ctx_inc}"
                if c.decode_bin(self.ctx.at("sig_coeff_flag", ctx_inc)):
                    sig_pos.append(n)
                    infer_sb_dc = False
            if not sig_pos:
                continue
            # sig_pos is in decreasing scan order
            # greater1 flags (max 8)
            ctx_set = 0 if (i == 0 or cidx > 0) else 2
            if prev_greater1_ctx_zero:
                ctx_set += 1
            cabac_mod.TRACE_LABEL[0] = f"g1 i={i} ns={len(sig_pos)}"
            greater1_ctx = 1
            g1 = {}
            first_g1_idx = -1
            for k, n in enumerate(sig_pos[:8]):
                ctx_inc = ctx_set * 4 + min(3, greater1_ctx)
                if cidx:
                    ctx_inc += 16
                f = c.decode_bin(self.ctx.at("coeff_abs_level_greater1_flag", ctx_inc))
                g1[n] = f
                if f:
                    greater1_ctx = 0
                    if first_g1_idx < 0:
                        first_g1_idx = k
                elif greater1_ctx > 0:
                    greater1_ctx += 1
            prev_greater1_ctx_zero = (greater1_ctx == 0)
            cabac_mod.TRACE_LABEL[0] = f"g2 i={i}"
            g2 = {}
            if first_g1_idx >= 0:
                n = sig_pos[first_g1_idx]
                ctx_inc = ctx_set if cidx == 0 else 4 + ctx_set
                g2[n] = c.decode_bin(self.ctx.at("coeff_abs_level_greater2_flag", ctx_inc))

            last_sig_scan = sig_pos[0]
            first_sig_scan = sig_pos[-1]
            hidden = sign_hiding and (last_sig_scan - first_sig_scan > 3)
            cabac_mod.TRACE_LABEL[0] = f"signs i={i} hidden={hidden}"
            signs = {}
            for k, n in enumerate(sig_pos):
                if hidden and n == first_sig_scan:
                    signs[n] = 0
                else:
                    signs[n] = c.decode_bypass()

            cabac_mod.TRACE_LABEL[0] = f"remaining i={i}"
            # persistent Rice adaptation (range ext): the Rice parameter
            # starts from StatCoeff[sbType]/4 per subblock and StatCoeff
            # adapts on the subblock's FIRST remaining-coded level
            # (reference slice.cc:3330-3376)
            rice = self.ctx.stat_coeff[sb_type] >> 2 if persistent else 0
            first_rem = True
            sum_abs = 0
            values = {}
            for k, n in enumerate(sig_pos):
                base = 1 + (g1.get(n, 0) if k < 8 else 0) + g2.get(n, 0)
                threshold = (3 if k == first_g1_idx else 2) if k < 8 else 1
                level = base
                if base == threshold:
                    rem = self._decode_remaining(rice)
                    level = base + rem
                    if level > (3 << rice):
                        rice = rice + 1 if persistent else min(rice + 1, 4)
                    if persistent and first_rem:
                        sc = self.ctx.stat_coeff[sb_type]
                        if rem >= (3 << (sc >> 2)):
                            self.ctx.stat_coeff[sb_type] = sc + 1
                        elif 2 * rem < (1 << (sc >> 2)) and sc > 0:
                            self.ctx.stat_coeff[sb_type] = sc - 1
                    first_rem = False
                values[n] = level
                sum_abs += level
            if hidden and (sum_abs & 1):
                signs[first_sig_scan] = 1
            for n in sig_pos:
                xP, yP = c_scan[n]
                xC, yC = (xS << 2) + xP, (yS << 2) + yP
                v = values[n]
                coeffs[yC, xC] = -v if signs[n] else v
        return coeffs

    def _decode_last_prefix(self, name, log2_size, ctx_off, ctx_shift):
        c = self.cabac
        cmax = (log2_size << 1) - 1
        v = 0
        while v < cmax:
            if not c.decode_bin(self.ctx.at(name, (v >> ctx_shift) + ctx_off)):
                break
            v += 1
        return v

    def _sig_ctx(self, xC, yC, xS, yS, log2_size, cidx, scan_idx, csbf, nsb):
        """spec 9.3.4.2.5 sig_coeff_flag ctxInc."""
        if log2_size == 2:
            sig = CTX_IDX_MAP_4x4[(yC << 2) + xC]
        elif xC + yC == 0:
            sig = 0
        else:
            right = csbf[yS, xS + 1] if xS + 1 < nsb else 0
            below = csbf[yS + 1, xS] if yS + 1 < nsb else 0
            prev = int(right) + 2 * int(below)
            xP, yP = xC & 3, yC & 3
            if prev == 0:
                sig = 2 if xP + yP == 0 else (1 if xP + yP < 3 else 0)
            elif prev == 1:
                sig = 2 if yP == 0 else (1 if yP == 1 else 0)
            elif prev == 2:
                sig = 2 if xP == 0 else (1 if xP == 1 else 0)
            else:
                sig = 2
            if cidx == 0:
                if xS or yS:
                    sig += 3
                if log2_size == 3:
                    sig += 9 if scan_idx == SCAN_DIAG else 15
                else:
                    sig += 21
            else:
                if log2_size == 3:
                    sig += 9
                else:
                    sig += 12
        return sig if cidx == 0 else 27 + sig

    def _decode_remaining(self, rice):
        """coeff_abs_level_remaining binarization (spec 9.3.3.9)."""
        c = self.cabac
        prefix = 0
        while prefix <= 32 and c.decode_bypass():
            prefix += 1
        if prefix > 32:
            raise ValueError("corrupted stream: remaining prefix runaway")
        if prefix <= 3:
            return (prefix << rice) + c.decode_bypass_bits(rice) if rice else prefix
        nbits = prefix - 3 + rice
        return (((1 << (prefix - 3)) + 3 - 1) << rice) + c.decode_bypass_bits(nbits)


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
