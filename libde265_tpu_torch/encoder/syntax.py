"""Copy of libde265_tpu/encoder/syntax.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

CTU/CU/TU syntax writer — the encoder-side mirror of bitstream/ctu.py
(spec 7.3.8 + 9.3.4), sharing its context-index derivations.

Capability counterpart of libde265/encoder-syntax.{h,cc}.
The writer maintains the same FramePlan metadata grids as the reader so that
context derivations (split depth, skip neighbors, MPM, QP prediction) are
identical by construction.
"""
import numpy as np

from .cabac_enc import CabacEncoder
from ..bitstream.contextmodel import ContextModelTable
from ..bitstream.scan import get_scan_order, SCAN_DIAG, SCAN_HORIZ, SCAN_VERT
from ..bitstream.ctu import CTX_IDX_MAP_4x4, clip3
from ..bitstream.sliceheader import SLICE_TYPE_I, SLICE_TYPE_P, SLICE_TYPE_B
from ..plan import FramePlan, MODE_INTRA, MODE_INTER, PART_2Nx2N, PART_NxN


class SliceWriter:
    """Writes one slice's CTU data; mirrors the JAX package's
    SliceReader (libde265_tpu/bitstream/ctu.py) state machine."""

    def __init__(self, frame: FramePlan, sh, init_ctx=None):
        self.frame = frame
        self.sps = frame.sps
        self.pps = frame.pps
        self.sh = sh
        if init_ctx is not None:
            self.ctx = init_ctx
        else:
            self.ctx = ContextModelTable()
            self.ctx.init_states(sh.initType, clip3(0, 51, sh.SliceQPY))
        self.cabac = CabacEncoder()
        self.ctb_log2 = self.sps.Log2CtbSizeY
        self.ctb_size = self.sps.CtbSizeY
        self.min_cb_log2 = self.sps.Log2MinCbSizeY
        self.W = self.sps.pic_width_in_luma_samples
        self.H = self.sps.pic_height_in_luma_samples
        self.pic_w_ctbs = self.sps.PicWidthInCtbsY
        self.last_cu_qp = sh.SliceQPY     # qPY_PREV (8.6.1)

    # availability identical to the reader's
    def available_zscan(self, x_curr, y_curr, x_nb, y_nb):
        from ..reconstruct import Availability
        if not hasattr(self, "_avail"):
            self._avail = Availability(self.frame)
        return self._avail.available(x_curr, y_curr, x_nb, y_nb)

    # ------------------------------------------------------------------
    def write_ctb(self, cx, cy, cu_emitter, last_ctb, sao_params=None,
                  end_substream=False):
        """cu_emitter(writer, x0, y0, log2, depth) emits each leaf CU.
        end_substream: emit end_of_subset_one_bit + flush after this CTB
        (tiles/WPP substream boundary)."""
        frame = self.frame
        frame.ctb_slice_seg[cy, cx] = self.sh.slice_segment_address
        frame.slice_addr_rs[cy, cx] = self.sh.SliceAddrRS
        xCtb, yCtb = cx << self.ctb_log2, cy << self.ctb_log2
        if self.sh.slice_sao_luma_flag or self.sh.slice_sao_chroma_flag:
            self._write_sao(cx, cy, xCtb, yCtb)
        self._quadtree(xCtb, yCtb, self.ctb_log2, 0, cu_emitter)
        self.cabac.encode_terminate(1 if last_ctb else 0)
        if not last_ctb and end_substream:
            self.cabac.encode_terminate(1)  # end_of_subset_one_bit + flush

    def start_substream(self, reinit=False, restore_ctx=None):
        """Collect the finished substream blob and restart the CABAC engine.
        reinit: re-initialize contexts (tiles); restore_ctx: table copy to
        restore (WPP row inheritance)."""
        from .cabac_enc import CabacEncoder
        if not hasattr(self, "blobs"):
            self.blobs = []
        if self.cabac.writer.bytes or not self.cabac.first_bit:
            self.blobs.append(self.cabac.data())
        self.cabac = CabacEncoder()
        if reinit:
            self.ctx.init_states(self.sh.initType,
                                 clip3(0, 51, self.sh.SliceQPY))
        elif restore_ctx is not None:
            self.ctx = restore_ctx

    def snapshot_ctx(self):
        import copy
        t = ContextModelTable.__new__(ContextModelTable)
        t.models = [m[:] for m in self.ctx.models]
        t.stat_coeff = list(self.ctx.stat_coeff)
        return t

    def finish(self):
        if not hasattr(self, "blobs"):
            self.blobs = []
        self.blobs.append(self.cabac.data())
        return self.blobs

    def _write_sao(self, cx, cy, xCtb, yCtb):
        """Mirror of SliceReader._read_sao; writes merge flags as 0 and the
        parameters already present in frame.sao (spec 7.3.8.3)."""
        sh, c, sao = self.sh, self.cabac, self.frame.sao
        if cx > 0 and self.available_zscan(xCtb, yCtb, xCtb - 1, yCtb):
            c.encode_bin(self.ctx.at("sao_merge_flag"), 0)
        if cy > 0 and self.available_zscan(xCtb, yCtb, xCtb, yCtb - 1):
            c.encode_bin(self.ctx.at("sao_merge_flag"), 0)
        for ci in range(3):
            if ci == 0 and not sh.slice_sao_luma_flag:
                continue
            if ci > 0 and not sh.slice_sao_chroma_flag:
                continue
            bitdepth = self.sps.BitDepthY if ci == 0 else self.sps.BitDepthC
            t = int(sao.type_idx[cy, cx, ci])
            if ci == 2:
                pass  # type inherited from Cb
            else:
                c.encode_bin(self.ctx.at("sao_type_idx"), 1 if t else 0)
                if t:
                    c.encode_bypass(1 if t == 2 else 0)
            if t == 0:
                continue
            cmax = (1 << (min(bitdepth, 10) - 5)) - 1
            offs = [int(v) for v in sao.offsets[cy, cx, ci]]
            for k in range(4):
                c.encode_tu_bypass(abs(offs[k]), cmax)
            if t == 1:
                for k in range(4):
                    if offs[k]:
                        c.encode_bypass(1 if offs[k] < 0 else 0)
                c.encode_bypass_bits(int(sao.band_pos[cy, cx, ci]), 5)
            else:
                if ci == 0:
                    c.encode_bypass_bits(int(sao.eo_class[cy, cx, 0]), 2)
                elif ci == 1:
                    c.encode_bypass_bits(int(sao.eo_class[cy, cx, 1]), 2)

    def _quadtree(self, x0, y0, log2_size, depth, cu_emitter):
        frame = self.frame
        # decide split: emit CUs at cu_emitter's preferred size
        want_split = cu_emitter.want_split(x0, y0, log2_size, depth)
        inside = x0 + (1 << log2_size) <= self.W and y0 + (1 << log2_size) <= self.H
        if inside and log2_size > self.min_cb_log2:
            ctx_inc = 0
            if self.available_zscan(x0, y0, x0 - 1, y0):
                if frame.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                    ctx_inc += 1
            if self.available_zscan(x0, y0, x0, y0 - 1):
                if frame.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                    ctx_inc += 1
            self.cabac.encode_bin(self.ctx.at("split_cu_flag", ctx_inc),
                                  1 if want_split else 0)
            split = want_split
        else:
            split = log2_size > self.min_cb_log2
        if split:
            half = 1 << (log2_size - 1)
            self._quadtree(x0, y0, log2_size - 1, depth + 1, cu_emitter)
            if x0 + half < self.W:
                self._quadtree(x0 + half, y0, log2_size - 1, depth + 1, cu_emitter)
            if y0 + half < self.H:
                self._quadtree(x0, y0 + half, log2_size - 1, depth + 1, cu_emitter)
            if x0 + half < self.W and y0 + half < self.H:
                self._quadtree(x0 + half, y0 + half, log2_size - 1, depth + 1,
                               cu_emitter)
        else:
            cu_emitter.emit(self, x0, y0, log2_size, depth)

    def qp_pred(self):
        """Luma QP prediction, one-CU-per-CTB quantization groups
        (diff_cu_qp_delta_depth 0): both spatial neighbours live in other
        CTBs, so the prediction is qPY_PREV — the previous CU's QP
        (mirrors the reader's 8.6.1 derivation for this stream shape)."""
        return self.last_cu_qp

    def write_cu_qp_delta(self, delta):
        """Mirror of the reader's _decode_cu_qp_delta: TU prefix (cMax 5,
        bin0 ctx0 / bins 1-4 ctx1) + EG0 suffix + sign bypass."""
        c = self.cabac
        v = abs(int(delta))
        prefix = min(v, 5)
        c.encode_bin(self.ctx.at("cu_qp_delta_abs", 0), 1 if prefix else 0)
        for _ in range(1, prefix):
            c.encode_bin(self.ctx.at("cu_qp_delta_abs", 1), 1)
        if 0 < prefix < 5:
            c.encode_bin(self.ctx.at("cu_qp_delta_abs", 1), 0)
        if v >= 5:
            c.encode_eg_bypass(v - 5, 0)
        if v:
            c.encode_bypass(1 if delta < 0 else 0)

    # ------------------------------------------------------- CU primitives
    def cu_metadata(self, x0, y0, log2_size, depth, pred_mode, skip):
        f = self.frame
        gx, gy, gs = x0 >> 2, y0 >> 2, (1 << log2_size) >> 2
        f.ct_depth[gy:gy + gs, gx:gx + gs] = depth
        f.log2_cb_size[gy:gy + gs, gx:gx + gs] = log2_size
        f.cb_boundary[gy:gy + gs, gx] |= 1
        f.cb_boundary[gy, gx:gx + gs] |= 2
        f.pred_mode[gy:gy + gs, gx:gx + gs] = pred_mode
        f.skip_flag[gy:gy + gs, gx:gx + gs] = 1 if skip else 0
        f.qp_y[gy:gy + gs, gx:gx + gs] = self.sh.SliceQPY

    def write_cross_comp(self, ci, alpha):
        """Cross-component prediction syntax for one chroma component
        (range ext, reference read_cross_comp_pred slice.cc:3530-3558):
        TR-coded log2_res_scale_abs_plus1 (cMax 4) + sign. alpha is the
        ResScaleVal: 0 or +/- a power of two up to 8."""
        c = self.cabac
        v = 0 if alpha == 0 else abs(alpha).bit_length()
        assert v <= 4 and (alpha == 0 or abs(alpha) == 1 << (v - 1))
        for b in range(v):
            c.encode_bin(self.ctx.at("log2_res_scale_abs_plus1",
                                     4 * (ci - 1) + b), 1)
        if v < 4:
            c.encode_bin(self.ctx.at("log2_res_scale_abs_plus1",
                                     4 * (ci - 1) + v), 0)
        if v:
            c.encode_bin(self.ctx.at("res_scale_sign_flag", ci - 1),
                         1 if alpha < 0 else 0)

    def write_cu_chroma_qp_offset(self, flag, idx=0):
        """TU-level chroma QP offset (range ext, slice.cc:3610-3635).
        Mirrors the reference's ONE-bin idx read."""
        c = self.cabac
        c.encode_bin(self.ctx.at("cu_chroma_qp_offset_flag"),
                     1 if flag else 0)
        if flag and len(self.pps.cb_qp_offset_list) > 1:
            c.encode_bin(self.ctx.at("cu_chroma_qp_offset_idx"), idx)

    def write_tq_bypass(self, x0, y0, size, flag):
        self.cur_tq_bypass = bool(flag)
        self.cabac.encode_bin(self.ctx.at("cu_transquant_bypass_flag"),
                              1 if flag else 0)
        f = self.frame
        gx, gy, gs = x0 >> 2, y0 >> 2, size >> 2
        f.tq_bypass[gy:gy + gs, gx:gx + gs] = 1 if flag else 0

    def write_skip_flag(self, x0, y0, skip):
        f = self.frame
        gx, gy = x0 >> 2, y0 >> 2
        ctx_inc = 0
        if self.available_zscan(x0, y0, x0 - 1, y0) and f.skip_flag[gy, gx - 1]:
            ctx_inc += 1
        if self.available_zscan(x0, y0, x0, y0 - 1) and f.skip_flag[gy - 1, gx]:
            ctx_inc += 1
        self.cabac.encode_bin(self.ctx.at("cu_skip_flag", ctx_inc), 1 if skip else 0)

    def write_pred_mode(self, intra):
        self.cabac.encode_bin(self.ctx.at("pred_mode_flag"), 1 if intra else 0)

    def write_merge_idx(self, idx):
        c = self.cabac
        if self.sh.MaxNumMergeCand <= 1:
            return
        c.encode_bin(self.ctx.at("merge_idx"), 1 if idx > 0 else 0)
        if idx > 0:
            for k in range(1, self.sh.MaxNumMergeCand - 1):
                if k < idx:
                    c.encode_bypass(1)
                else:
                    c.encode_bypass(0)
                    break

    def write_merge_flag(self, merge):
        self.cabac.encode_bin(self.ctx.at("merge_flag"), 1 if merge else 0)

    def write_mvd(self, mvd):
        c = self.cabac
        for i in range(2):
            c.encode_bin(self.ctx.at("abs_mvd_greater_flag", 0),
                         1 if abs(mvd[i]) > 0 else 0)
        for i in range(2):
            if abs(mvd[i]) > 0:
                c.encode_bin(self.ctx.at("abs_mvd_greater_flag", 1),
                             1 if abs(mvd[i]) > 1 else 0)
        for i in range(2):
            a = abs(mvd[i])
            if a > 0:
                if a > 1:
                    c.encode_eg_bypass(a - 2, 1)
                c.encode_bypass(1 if mvd[i] < 0 else 0)

    def write_ref_idx(self, idx, num_active):
        if num_active <= 1:
            return
        c = self.cabac
        c.encode_bin(self.ctx.at("ref_idx", 0), 1 if idx > 0 else 0)
        if idx > 0 and num_active > 2:
            c.encode_bin(self.ctx.at("ref_idx", 1), 1 if idx > 1 else 0)
            if idx > 1:
                for k in range(2, num_active - 1):
                    if k < idx:
                        c.encode_bypass(1)
                    else:
                        c.encode_bypass(0)
                        break

    def write_inter_pred_idc(self, idc, w, h, ct_depth):
        # 0=L0, 1=L1, 2=BI (spec 9.3.3.7 binarization)
        c = self.cabac
        if w + h != 12:
            c.encode_bin(self.ctx.at("inter_pred_idc", ct_depth), 1 if idc == 2 else 0)
            if idc == 2:
                return
        c.encode_bin(self.ctx.at("inter_pred_idc", 4), 1 if idc == 1 else 0)

    def write_mvp_flag(self, flag):
        self.cabac.encode_bin(self.ctx.at("mvp_flag"), flag)

    def write_part_mode_intra(self, log2_size, part_mode):
        if log2_size == self.min_cb_log2:
            self.cabac.encode_bin(self.ctx.at("part_mode", 0),
                                  1 if part_mode == PART_2Nx2N else 0)

    def write_part_mode_inter_2nx2n(self, log2_size):
        self.cabac.encode_bin(self.ctx.at("part_mode", 0), 1)

    def write_part_mode_inter(self, log2_size, part_mode):
        """General inter part_mode binarization (mirror of the reader's
        _decode_part_mode_inter; CU > MinCb with/without AMP)."""
        from ..plan import (PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_2NxnU,
                            PART_2NxnD, PART_nLx2N, PART_nRx2N)
        c = self.cabac
        if part_mode == PART_2Nx2N:
            c.encode_bin(self.ctx.at("part_mode", 0), 1)
            return
        assert log2_size > self.min_cb_log2, "2-PU modes need CU > MinCb"
        c.encode_bin(self.ctx.at("part_mode", 0), 0)
        horiz = part_mode in (PART_2NxN, PART_2NxnU, PART_2NxnD)
        c.encode_bin(self.ctx.at("part_mode", 1), 1 if horiz else 0)
        if not self.sps.amp_enabled_flag:
            assert part_mode in (PART_2NxN, PART_Nx2N)
            return
        symmetric = part_mode in (PART_2NxN, PART_Nx2N)
        c.encode_bin(self.ctx.at("part_mode", 3), 1 if symmetric else 0)
        if not symmetric:
            c.encode_bypass(
                1 if part_mode in (PART_2NxnD, PART_nRx2N) else 0)

    def write_rqt_root_cbf(self, cbf):
        self.cabac.encode_bin(self.ctx.at("rqt_root_cbf"), 1 if cbf else 0)

    def write_pcm(self, x0, y0, log2_size, ysamples, cbsamples, crsamples,
                  bit_depth=8):
        """pcm_flag=1 (terminate+flush), aligned raw samples, engine restart
        (spec 7.3.8.7 / 9.3.4.3.5). Caller wrote the CU header up to
        part_mode."""
        c = self.cabac
        c.encode_terminate(1)          # pcm_flag; flush + byte align
        w = c.writer
        n = 1 << log2_size
        for row in ysamples:
            for v in row:
                w.put_bits(int(v), bit_depth)
        for plane in (cbsamples, crsamples):
            for row in plane:
                for v in row:
                    w.put_bits(int(v), bit_depth)
        c.reset_engine()
        f = self.frame
        gx, gy, gs = x0 >> 2, y0 >> 2, n >> 2
        f.pcm_flag[gy:gy + gs, gx:gx + gs] = 1
        # PCM CUs count as intra with mode INTRA_DC for neighbors (spec treats
        # them as unavailable for MPM via the pcm flag; grids already mark it)

    # ------------------------------------------------------------- intra
    def derive_mpm(self, x, y):
        """Same MPM derivation as the reader (spec 8.4.2)."""
        frame = self.frame

        def neigh_mode(nx, ny, same_ctb_row=False):
            if not self.available_zscan(x, y, nx, ny):
                return 1
            if same_ctb_row and (ny >> self.ctb_log2) != (y >> self.ctb_log2):
                return 1
            if frame.pred_mode[ny >> 2, nx >> 2] != MODE_INTRA or \
                    frame.pcm_flag[ny >> 2, nx >> 2]:
                return 1
            return int(frame.intra_mode_y[ny >> 2, nx >> 2])
        cand_a = neigh_mode(x - 1, y)
        cand_b = neigh_mode(x, y - 1, same_ctb_row=True)
        if cand_a == cand_b:
            if cand_a < 2:
                return [0, 1, 26]
            return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
        mpm = [cand_a, cand_b, 0]
        if cand_a != 0 and cand_b != 0:
            mpm[2] = 0
        elif cand_a + cand_b < 2:
            mpm[2] = 26
        else:
            mpm[2] = 1
        return mpm

    def write_intra_modes(self, x0, y0, log2_size, modes, chroma_dm=True):
        """2Nx2N only (modes = [luma_mode]); writes prev flag/mpm/rem +
        chroma derived mode, and records metadata grids."""
        c = self.cabac
        f = self.frame
        mode = modes[0]
        mpm = self.derive_mpm(x0, y0)
        if mode in mpm:
            c.encode_bin(self.ctx.at("prev_intra_luma_pred_flag"), 1)
            idx = mpm.index(mode)
            c.encode_tu_bypass_ctxfree = None
            # mpm_idx: TU cMax=2 bypass
            if idx == 0:
                c.encode_bypass(0)
            elif idx == 1:
                c.encode_bypass(1)
                c.encode_bypass(0)
            else:
                c.encode_bypass(1)
                c.encode_bypass(1)
        else:
            c.encode_bin(self.ctx.at("prev_intra_luma_pred_flag"), 0)
            srt = sorted(mpm)
            rem = mode
            for m in reversed(srt):
                if rem > m:
                    rem -= 1
            c.encode_bypass_bits(rem, 5)
        gs = (1 << log2_size) >> 2
        gx, gy = x0 >> 2, y0 >> 2
        f.intra_mode_y[gy:gy + gs, gx:gx + gs] = mode
        # chroma: derived (DM) mode; absent for monochrome, remapped
        # through Table 8-23 for 4:2:2
        cat = self.frame.sps.ChromaArrayType
        if cat != 0:
            c.encode_bin(self.ctx.at("intra_chroma_pred_mode"), 0)
            cmode = mode
            if cat == 2:
                from ..bitstream.ctu import MAP_CHROMA_422
                cmode = MAP_CHROMA_422[mode]
            f.intra_mode_c[gy:gy + gs, gx:gx + gs] = cmode

    def write_intra_modes_nxn(self, x0, y0, log2_size, modes):
        """PART_NxN: 4 luma modes. Syntax order: all 4
        prev_intra_luma_pred_flags, then all 4 mpm_idx/rem values, then
        the chroma mode(s) (one DM per CU; per-PB for 4:4:4). MPM
        derivation is sequential — each part sees earlier parts' modes
        in the grid (slice.cc:4382-4443)."""
        c = self.cabac
        f = self.frame
        pb = (1 << log2_size) >> 1
        flags, vals = [], []
        for i, mode in enumerate(modes):
            px, py = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            mpm = self.derive_mpm(px, py)
            if mode in mpm:
                flags.append(1)
                vals.append(("mpm", mpm.index(mode)))
            else:
                srt = sorted(mpm)
                rem = mode
                for m in reversed(srt):
                    if rem > m:
                        rem -= 1
                flags.append(0)
                vals.append(("rem", rem))
            gs = pb >> 2
            f.intra_mode_y[py >> 2:(py >> 2) + gs,
                           px >> 2:(px >> 2) + gs] = mode
        for fl in flags:
            c.encode_bin(self.ctx.at("prev_intra_luma_pred_flag"), fl)
        for kind, v in vals:
            if kind == "mpm":
                if v == 0:
                    c.encode_bypass(0)
                elif v == 1:
                    c.encode_bypass(1)
                    c.encode_bypass(0)
                else:
                    c.encode_bypass(1)
                    c.encode_bypass(1)
            else:
                c.encode_bypass_bits(v, 5)
        cat = f.sps.ChromaArrayType
        if cat == 3:
            # per-PB derived (DM) chroma mode
            for i, mode in enumerate(modes):
                px, py = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
                c.encode_bin(self.ctx.at("intra_chroma_pred_mode"), 0)
                gs = pb >> 2
                f.intra_mode_c[py >> 2:(py >> 2) + gs,
                               px >> 2:(px >> 2) + gs] = mode
        elif cat != 0:
            c.encode_bin(self.ctx.at("intra_chroma_pred_mode"), 0)
            cmode = modes[0]
            if cat == 2:
                from ..bitstream.ctu import MAP_CHROMA_422
                cmode = MAP_CHROMA_422[cmode]
            gs = (1 << log2_size) >> 2
            f.intra_mode_c[y0 >> 2:(y0 >> 2) + gs,
                           x0 >> 2:(x0 >> 2) + gs] = cmode

    # --------------------------------------------------------- transform
    def write_split_transform_flag(self, log2_size, split):
        self.cabac.encode_bin(self.ctx.at("split_transform_flag", 5 - log2_size),
                              1 if split else 0)

    def write_cbf_chroma(self, depth, cbf):
        self.cabac.encode_bin(self.ctx.at("cbf_chroma", depth), 1 if cbf else 0)

    def write_cbf_luma(self, depth0, cbf):
        self.cabac.encode_bin(self.ctx.at("cbf_luma", 1 if depth0 else 0),
                              1 if cbf else 0)

    def record_tu(self, x0, y0, log2_size, cbf_luma):
        f = self.frame
        gx, gy, gs = x0 >> 2, y0 >> 2, (1 << log2_size) >> 2
        f.tu_boundary[gy:gy + gs, gx] |= 1
        f.tu_boundary[gy, gx:gx + gs] |= 2
        f.cbf_luma[gy:gy + gs, gx:gx + gs] = 1 if cbf_luma else 0

    # ------------------------------------------------------ residual (7.3.8.11)
    def write_residual(self, coeffs, log2_size, cidx, scan_idx=SCAN_DIAG,
                       ts=False, inter=False, rdpcm=0):
        """coeffs: (n,n) int array (y,x). Mirrors the reader exactly.
        ts: transform_skip_flag for this block (written whenever the PPS
        enables transform skip, the block size allows it, and the CU is
        not transquant-bypassed — spec 7.3.8.11; omitting the bypass
        guard desynced every conforming decoder on lossless x tskip
        streams, the round-4 known bug).
        inter: CU pred mode is inter — gates the explicit-rdpcm syntax
        (range ext, slice.cc:2937-2951); rdpcm 0 none / 1 h / 2 v."""
        c = self.cabac
        bypass = getattr(self, "cur_tq_bypass", False)
        if self.pps.transform_skip_enabled_flag and not bypass and \
                log2_size <= self.pps.log2_max_transform_skip_block_size:
            c.encode_bin(self.ctx.at("transform_skip_flag",
                                     0 if cidx == 0 else 1), 1 if ts else 0)
        if inter and self.sps.explicit_rdpcm_enabled_flag and (ts or bypass):
            c.encode_bin(self.ctx.at("explicit_rdpcm_flag",
                                     0 if cidx == 0 else 1),
                         1 if rdpcm else 0)
            if rdpcm:
                c.encode_bin(self.ctx.at("explicit_rdpcm_dir_flag",
                                         0 if cidx == 0 else 1),
                             1 if rdpcm == 2 else 0)
        # persistent Rice adaptation + transform-skip sig-ctx (range ext)
        sb_type = (2 if cidx == 0 else 0) + (1 if (ts or bypass) else 0)
        persistent = bool(self.sps.persistent_rice_adaptation_enabled_flag)
        ts_ctx = bool(self.sps.transform_skip_context_enabled_flag) and \
            (ts or bypass)
        size = 1 << log2_size
        nz = np.nonzero(coeffs)
        assert len(nz[0]) > 0
        c_scan = get_scan_order(4, scan_idx)
        sb_scan = get_scan_order(size >> 2, scan_idx)
        sb_index = {p: i for i, p in enumerate(sb_scan)}
        c_index = {p: i for i, p in enumerate(c_scan)}
        # last significant coefficient in the subblock-grouped coding order
        best = -1
        lastx = lasty = 0
        for (y, x) in zip(nz[0], nz[1]):
            key = sb_index[(x >> 2, y >> 2)] * 16 + c_index[(x & 3, y & 3)]
            if key > best:
                best = key
                lastx, lasty = int(x), int(y)

        # last_sig prefix/suffix (9.3.3.8)
        lx, ly = (lasty, lastx) if scan_idx == SCAN_VERT else (lastx, lasty)
        for val, name in ((lx, "last_sig_coeff_x_prefix"), (ly, "last_sig_coeff_y_prefix")):
            if cidx == 0:
                ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
                ctx_shift = (log2_size + 1) >> 2
            else:
                ctx_off, ctx_shift = 15, log2_size - 2
            if val > 3:
                group = (val.bit_length())  # groupIdx
                # prefix value: for val>3: prefix = (bit_length of val)*2 - ... use
                # standard: prefix p such that val in [ (2+(p&1))<<((p>>1)-1) , ... )
                p = 0
                while True:
                    if p <= 3:
                        lo, hi = p, p
                    else:
                        nb = (p >> 1) - 1
                        lo = (2 + (p & 1)) << nb
                        hi = lo + (1 << nb) - 1
                    if lo <= val <= hi:
                        break
                    p += 1
                prefix = p
            else:
                prefix = val
            cmax = (log2_size << 1) - 1
            for k in range(prefix):
                c.encode_bin(self.ctx.at(name, (k >> ctx_shift) + ctx_off), 1)
            if prefix < cmax:
                c.encode_bin(self.ctx.at(name, (prefix >> ctx_shift) + ctx_off), 0)
        # suffixes
        for val in (lx, ly):
            if val > 3:
                p = 0
                while True:
                    if p <= 3:
                        lo, hi = p, p
                    else:
                        nb = (p >> 1) - 1
                        lo = (2 + (p & 1)) << nb
                        hi = lo + (1 << nb) - 1
                    if lo <= val <= hi:
                        break
                    p += 1
                nb = (p >> 1) - 1
                c.encode_bypass_bits(val - ((2 + (p & 1)) << nb), nb)

        nsb = size >> 2
        csbf = np.zeros((nsb, nsb), np.uint8)
        # which subblocks have nonzero
        for (x, y) in zip(nz[1], nz[0]):
            csbf[y >> 2, x >> 2] = 1
        last_sb = sb_index[(lastx >> 2, lasty >> 2)]
        last_pos = c_index[(lastx & 3, lasty & 3)]
        prev_g1_zero = False

        for i in range(last_sb, -1, -1):
            xS, yS = sb_scan[i]
            infer_dc = False
            if i < last_sb and i > 0:
                right = csbf[yS, xS + 1] if xS + 1 < nsb else 0
                below = csbf[yS + 1, xS] if yS + 1 < nsb else 0
                ctx_inc = min(int(right) + int(below), 1) + (2 if cidx else 0)
                c.encode_bin(self.ctx.at("coded_sub_block_flag", ctx_inc),
                             int(csbf[yS, xS]))
                infer_dc = True
                if not csbf[yS, xS]:
                    continue
            else:
                csbf[yS, xS] = 1
            # sig flags
            sig_pos = []
            start = last_pos - 1 if i == last_sb else 15
            if i == last_sb:
                sig_pos.append(last_pos)
            for n in range(start, -1, -1):
                xP, yP = c_scan[n]
                xC, yC = (xS << 2) + xP, (yS << 2) + yP
                sig = 1 if coeffs[yC, xC] else 0
                if n == 0 and infer_dc and not sig_pos:
                    # must be significant (inferred) — caller guarantees
                    assert sig, "inferred-DC subblock with zero DC"
                    sig_pos.append(0)
                    continue
                ctx_inc = (42 if cidx == 0 else 43) if ts_ctx else \
                    _sig_ctx(xC, yC, xS, yS, log2_size, cidx,
                             scan_idx, csbf, nsb)
                c.encode_bin(self.ctx.at("sig_coeff_flag", ctx_inc), sig)
                if sig:
                    sig_pos.append(n)
                    infer_dc = False
            if not sig_pos:
                continue
            levels = []
            for n in sig_pos:
                xP, yP = c_scan[n]
                levels.append(int(coeffs[(yS << 2) + yP, (xS << 2) + xP]))
            # greater1
            ctx_set = 0 if (i == 0 or cidx > 0) else 2
            if prev_g1_zero:
                ctx_set += 1
            g1ctx = 1
            first_g1 = -1
            for k, lv in enumerate(levels[:8]):
                ctx_inc = ctx_set * 4 + min(3, g1ctx)
                if cidx:
                    ctx_inc += 16
                flag = 1 if abs(lv) > 1 else 0
                c.encode_bin(self.ctx.at("coeff_abs_level_greater1_flag", ctx_inc), flag)
                if flag:
                    g1ctx = 0
                    if first_g1 < 0:
                        first_g1 = k
                elif g1ctx > 0:
                    g1ctx += 1
            prev_g1_zero = (g1ctx == 0)
            if first_g1 >= 0:
                ctx_inc = ctx_set if cidx == 0 else 4 + ctx_set
                flag = 1 if abs(levels[first_g1]) > 2 else 0
                c.encode_bin(self.ctx.at("coeff_abs_level_greater2_flag", ctx_inc), flag)
            # signs; with sign_data_hiding the FIRST coefficient in scan
            # order of a wide-enough sub-block omits its sign — the
            # encoder pre-normalized the level-sum parity to carry it
            # (reader: ctu.py sign_hiding/sum_abs)
            hidden = bool(self.pps.sign_data_hiding_flag) and not bypass \
                and (sig_pos[0] - sig_pos[-1] > 3)
            for k, lv in enumerate(levels):
                if hidden and k == len(levels) - 1:
                    continue
                c.encode_bypass(1 if lv < 0 else 0)
            # remaining (persistent Rice mirrors the reader, ctu.py /
            # reference slice.cc:3330-3376)
            rice = self.ctx.stat_coeff[sb_type] >> 2 if persistent else 0
            first_rem = True
            for k, lv in enumerate(levels):
                a = abs(lv)
                if k < 8:
                    base = 1 + (1 if a > 1 else 0) + (1 if (k == first_g1 and a > 2) else 0)
                    threshold = (3 if k == first_g1 else 2)
                else:
                    base = 1
                    threshold = 1
                if base == threshold:
                    rem = a - base
                    _encode_remaining(c, rem, rice)
                    if a > (3 << rice):
                        rice = rice + 1 if persistent else min(rice + 1, 4)
                    if persistent and first_rem:
                        sc = self.ctx.stat_coeff[sb_type]
                        if rem >= (3 << (sc >> 2)):
                            self.ctx.stat_coeff[sb_type] = sc + 1
                        elif 2 * rem < (1 << (sc >> 2)) and sc > 0:
                            self.ctx.stat_coeff[sb_type] = sc - 1
                    first_rem = False


def _encode_remaining(c, v, rice):
    """Inverse of CabacDecoder/ctu._decode_remaining (9.3.3.9)."""
    if (v >> rice) < 4:
        prefix = v >> rice
        for _ in range(prefix):
            c.encode_bypass(1)
        c.encode_bypass(0)
        if rice:
            c.encode_bypass_bits(v & ((1 << rice) - 1), rice)
    else:
        # escape: find p >= 3 + 1 s.t. value in range
        p = 4
        while True:
            base = ((1 << (p - 3)) + 2) << rice
            hi = base + (1 << (p - 3 + rice)) - 1
            lo = base
            if lo <= v <= hi:
                break
            p += 1
            if p > 36:
                raise ValueError("remaining too large")
        for _ in range(p):
            c.encode_bypass(1)
        c.encode_bypass(0)
        c.encode_bypass_bits(v - lo, p - 3 + rice)


def _sig_ctx(xC, yC, xS, yS, log2_size, cidx, scan_idx, csbf, nsb):
    """Shared sig_coeff_flag ctxInc (same as SliceReader._sig_ctx)."""
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
            sig += 9 if log2_size == 3 else 12
    return sig if cidx == 0 else 27 + sig
