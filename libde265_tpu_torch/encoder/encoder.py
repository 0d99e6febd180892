"""Copy of libde265_tpu/encoder/encoder.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Minimal conforming HEVC Main-profile encoder (en265-equivalent capability,
libde265/encoder/encoder-core.h:70-130) used both as a real
encoder and as the test-vector generator for the inter decode path.

Design: fixed-QP, fixed CU size, closed-loop — every CU is reconstructed with
the *decoder's own exact ops* (intra_ref / inter_ref / transform_ref) as it is
encoded, so reference frames match any conforming decoder bit-exactly.
Quantization projects the residual onto the decoder's exact reconstruction
basis (impulse responses of dequant+inverse-transform), so no forward-quant
spec constants are needed.
"""
from dataclasses import dataclass, field
from typing import List
import numpy as np

from .cabac_enc import add_emulation_prevention
from .headers import write_vps, write_sps, write_pps, write_slice_header
from .syntax import SliceWriter
from ..bitstream.paramsets import read_sps, read_pps
from ..bitstream.sliceheader import SLICE_TYPE_I, SLICE_TYPE_P
from ..bitstream.scan import SCAN_DIAG, SCAN_HORIZ, SCAN_VERT
from ..plan import FramePlan, MODE_INTRA, MODE_INTER, PART_2Nx2N
from ..ops import intra_ref, transform_ref, inter_ref
from ..reconstruct import Availability, gather_border
from ..dpb import DPB, DPBPicture, SHORT_TERM
from ..motion import MotionDeriver


@dataclass
class EncoderConfig:
    width: int = 64
    height: int = 64
    qp: int = 30
    log2_ctb: int = 5
    log2_min_cb: int = 3
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    cu_log2: int = 4                  # emitted CU size
    log2_max_poc_lsb: int = 6
    sao: bool = False
    disable_deblocking: bool = True
    sign_data_hiding: bool = False
    transform_skip: bool = False
    cu_qp_delta: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: bool = False
    luma_log2_weight_denom: int = 6
    luma_weight_delta: int = 0
    luma_offset: int = 0
    num_ref_l0: int = 1
    max_merge_cand: int = 5
    temporal_mvp: bool = False
    amp: bool = False
    strong_intra_smoothing: bool = False
    intra_period: int = 0             # 0: only first frame intra
    write_hash_sei: bool = False      # append decoded-picture-hash suffix SEI
    tiles: tuple = None               # (cols, rows) uniform tile grid
    tile_col_widths: tuple = None     # explicit CTB column widths
                                      # (uniform_spacing=0, pps.h:109-151)
    tile_row_heights: tuple = None    # explicit CTB row heights
    lf_across_tiles: bool = True
    wpp: bool = False                 # entropy_coding_sync (one substream/row)
    num_slices: int = 1               # independent slices per frame (CTB rows)
    scaling_lists: bool = False       # enable SPS default scaling lists
    tq_bypass: bool = False           # every 3rd CU coded lossless
    dependent_slices: bool = False    # slices 2..n emitted as dependent segs
    b_frames: bool = False            # code inter frames as (generalized) B
    bit_depth: int = 8                # 8 or 10 (Main / Main-10 style)
    chroma_format: int = 1            # chroma_format_idc: 0 mono, 1 4:2:0,
                                      # 2 4:2:2, 3 4:4:4 (non-420 is
                                      # intra-only for now)
    nxn_intra: bool = False           # 8x8 intra CUs code PART_NxN with
                                      # 4 luma modes + forced TT split
                                      # (exercises blk3 chroma
                                      # aggregation / 4:2:2 dual-cbf-at-
                                      # split / 4:4:4 per-leaf cbf);
                                      # requires cu_log2 == 3
    pcm: bool = False                 # every 5th intra CU coded as raw PCM
    pcm_loop_filter_disable: bool = False
    use_cra: bool = False             # non-first intra pictures as CRA (21)
    use_ltr: bool = False             # keep the IDR as a long-term reference
    fps: float = 0.0                  # write VUI timing info when set
    temporal_layers: bool = False     # odd frames at temporal id 1 (TSA_R)
    mixed_filter_slices: bool = False  # per-slice deblock/SAO flag variation
    rdo: bool = False                 # RD-optimized mode decision (rdo.py)
    rdo_search_range: int = 8         # integer-pel motion search range
    bitrate_kbps: float = 0.0         # >0: rate control (ratectrl.py)
    # ---- range-extension residual tools (round 5; reference
    # slice.cc:2937-2951,3330-3366,3530-3558, transform.cc:235-251,395-429)
    tskip_rotation: bool = False      # SPS: rotate 4x4 intra ts/bypass
    transform_skip_context: bool = False  # SPS: sig ctx 42/43 for ts/bypass
    implicit_rdpcm: bool = False      # SPS: intra ts/bypass mode 10/26 DPCM
    explicit_rdpcm: bool = False      # SPS: inter ts/bypass signalled DPCM
    persistent_rice: bool = False     # SPS: StatCoeff Rice adaptation
    intra_smoothing_disabled: bool = False  # SPS: no [1,2,1]/strong filter
    cross_comp_pred: bool = False     # PPS: chroma-from-luma residual
                                      # prediction (4:4:4 only)
    chroma_qp_offset_list: tuple = ()  # PPS: ((cb,cr),..) TU-level offsets

    @property
    def maxval(self):
        return (1 << self.bit_depth) - 1

    @property
    def pix_dtype(self):
        import numpy as _np
        return _np.uint8 if self.bit_depth == 8 else _np.uint16
    intra_modes: tuple = (26, 10, 0, 1, 18, 34, 2, 23)  # cycled per CU
    intra_mode_sel: str = "cycle"     # cycle (vector-gen diversity) |
                                      # minsad (content-adaptive pick —
                                      # the non-RDO quality default;
                                      # reference counterpart:
                                      # Algo_TB_IntraPredMode_MinResidual)
    inter_mode: str = "skip"          # skip | mv | mixed | gmv | 2pu
    mv_patterns: tuple = ((0, 0), (4, 0), (0, 4), (5, 3), (-7, 2), (9, -6),
                          (13, 21), (-2, -2))
    mv_jitter: int = 0                # gmv mode: add a deterministic
                                      # per-CU qpel jitter in [-J, J] to
                                      # global_mv — spreads MVs over every
                                      # fractional phase / alignment class
                                      # (realistic-motion MC benchmarks)
    global_mv: tuple = (0, 0)         # qpel MV for inter_mode="gmv": every
                                      # CU codes this true motion (mvd =
                                      # gmv - AMVP predictor), residual
                                      # only where prediction misses —
                                      # realistic pan-shot stream shape
    inter_residual: bool = False
    constrained_intra: bool = False   # PPS constrained_intra_pred: intra
                                      # borders substitute non-intra
                                      # neighbours (gather_border cip)
    ref_list_reverse: bool = False    # code ref_pic_lists_modification
                                      # reversing the default RPS order
    cabac_init: bool = False          # cabac_init_flag=1: swapped P/B
                                      # context init tables (9.3.2.2)
    mvd_l1_zero: bool = False         # B slices: L1 mvd inferred zero
                                      # for bi-pred PUs
    two_pu_merge: bool = False        # 2pu mode: odd CUs merge their
                                      # second PU (partIdx-1 candidate
                                      # exclusion paths)

    @property
    def pic_size_in_ctbs(self):
        wc = -(-self.width // (1 << self.log2_ctb))
        hc = -(-self.height // (1 << self.log2_ctb))
        return wc * hc


class _FakeDecoderCtx:
    """Just enough decoder context for MotionDeriver inside the encoder."""

    def __init__(self, dpb):
        self.dpb = dpb


class _CUEmitter:
    """Decides quadtree shape and emits each CU (mode decisions + recon)."""

    def __init__(self, enc, slice_type):
        self.enc = enc
        self.slice_type = slice_type
        self.cu_count = 0

    def want_split(self, x0, y0, log2_size, depth):
        return log2_size > self.enc.cfg.cu_log2

    QP_CYCLE = (0, 2, -2, 4, -4, 7, -6, 1)

    def emit(self, sw: SliceWriter, x0, y0, log2_size, depth):
        enc = self.enc
        idx = self.cu_count
        self.cu_count += 1
        enc._cur_bypass = False
        if enc.cfg.cu_qp_delta:
            want = enc._frame_base_qp + self.QP_CYCLE[
                idx % len(self.QP_CYCLE)]
            want = max(0, min(51, want))
            enc.cur_qp = want
            enc._pending_qp_delta = want - sw.qp_pred()
        if enc.cfg.tq_bypass:
            enc._cur_bypass = (idx % 3 == 0)
            sw.write_tq_bypass(x0, y0, 1 << log2_size, enc._cur_bypass)
        if self.slice_type == SLICE_TYPE_I:
            enc._emit_intra_cu(sw, x0, y0, log2_size, depth, idx)
        else:
            mode = enc.cfg.inter_mode
            if mode == "mixed":
                mode = ("skip", "mv", "intra", "mv_res")[idx % 4]
            elif mode == "mv" and enc.cfg.inter_residual:
                mode = "mv_res"
            if mode == "gmv":
                enc._emit_gmv_cu(sw, x0, y0, log2_size, depth, idx)
            elif mode == "2pu":
                enc._emit_2pu_cu(sw, x0, y0, log2_size, depth, idx)
            elif mode == "intra":
                sw.write_skip_flag(x0, y0, False)
                sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTRA, False)
                sw.write_pred_mode(True)
                enc._emit_intra_cu(sw, x0, y0, log2_size, depth, idx,
                                   header_done=True)
            elif mode == "skip":
                enc._emit_skip_cu(sw, x0, y0, log2_size, depth, idx)
            else:
                enc._emit_mv_cu(sw, x0, y0, log2_size, depth, idx,
                                with_residual=(mode == "mv_res"))
        if enc.cfg.cu_qp_delta:
            if enc._pending_qp_delta is not None:
                # no coded cbf in the CU: the reader derives QP = pred
                enc.cur_qp = sw.qp_pred()
                enc._pending_qp_delta = None
            sw.last_cu_qp = enc.cur_qp
            gs = (1 << log2_size) >> 2
            enc.frame.qp_y[y0 >> 2:(y0 >> 2) + gs,
                           x0 >> 2:(x0 >> 2) + gs] = enc.cur_qp


class Encoder:
    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        if cfg.sign_data_hiding:
            assert not cfg.tq_bypass and not cfg.rdo, \
                "sign hiding vectors: no tq-bypass/RDO mixing"
        if cfg.cu_qp_delta:
            # one-CU-per-CTB quantization groups, single substream
            assert cfg.diff_cu_qp_delta_depth == 0 and \
                cfg.cu_log2 == cfg.log2_ctb and cfg.tiles is None and \
                not cfg.wpp and cfg.num_slices == 1 and not cfg.pcm and \
                not cfg.nxn_intra and not cfg.rdo and not cfg.tq_bypass \
                and cfg.log2_max_tb >= cfg.cu_log2, \
                "cu_qp_delta emission: CU==CTB, single TU, single substream"
        if cfg.chroma_format != 1:
            # RDO mode decision is tuned for 4:2:0 distortion weighting
            assert not cfg.rdo, "non-4:2:0: no RDO"
        if cfg.cross_comp_pred:
            assert cfg.chroma_format == 3, "cross-comp pred is 4:4:4-only"
            assert not cfg.nxn_intra, "ccp vectors: 2Nx2N intra only"
        if cfg.chroma_qp_offset_list:
            # the reference reads cu_chroma_qp_offset_idx as ONE bin
            # (slice.cc:3621-3624) — keep lists at <=2 entries
            assert len(cfg.chroma_qp_offset_list) <= 2
            assert all(-12 <= v <= 12 for p in cfg.chroma_qp_offset_list
                       for v in p)
            assert not cfg.nxn_intra and not cfg.rdo
        if cfg.persistent_rice:
            # the reference leaves StatCoeff uninitialized across
            # dependent-slice / WPP thread contexts (decctx.cc:57-90) —
            # dec265's behaviour there is undefined; keep the oracle
            # well-defined
            assert not cfg.dependent_slices and not cfg.wpp
        if cfg.implicit_rdpcm or cfg.explicit_rdpcm or cfg.tskip_rotation:
            assert cfg.transform_skip or cfg.tq_bypass, \
                "rdpcm/rotation need a tskip or bypass residual path"
        # self-parse our own headers for exact derived geometry
        self.sps_nal = write_sps(cfg)
        self.pps_nal = write_pps(cfg)
        self.vps_nal = write_vps()
        from ..bitstream.nal import unescape_rbsp
        self.sps = read_sps(unescape_rbsp(self.sps_nal)[0])
        self.pps = read_pps(unescape_rbsp(self.pps_nal)[0], {0: self.sps})
        self.dpb = DPB()
        self._basis_cache = {}
        self.cur_qp = cfg.qp           # per-frame QP (rate control)
        self._pending_qp_delta = None
        self._ctb_counter = 0          # chroma-qp-offset group cycle
        self._cuc_qp_off = (0, 0)      # active TU-level chroma offsets
        self._chroma_off_coded = True
        self._chroma_off_next = (False, 0)
        self._frame_base_qp = cfg.qp
        self.rc = None
        if getattr(cfg, "bitrate_kbps", 0):
            from .ratectrl import RateController
            self.rc = RateController(cfg.bitrate_kbps, cfg.fps or 25.0,
                                     cfg.qp, cfg.intra_period)

    # ------------------------------------------------------------ stream
    def encode(self, frames: List[list]) -> bytes:
        """frames: list of [Y,Cb,Cr] uint8 planes. Returns Annex-B bytes."""
        out = bytearray()
        for nal in (self.vps_nal, self.sps_nal, self.pps_nal):
            out += b"\x00\x00\x00\x01" + nal
        for i, planes in enumerate(frames):
            intra = (i == 0) or (self.cfg.intra_period and
                                 i % self.cfg.intra_period == 0)
            if self.rc is not None:
                self.cur_qp = self.rc.qp_for_frame(intra)
            n0 = len(out)
            out += self._encode_frame(planes, i, intra)
            if self.rc is not None:
                self.rc.update((len(out) - n0) * 8, intra)
            if self.cfg.write_hash_sei:
                from ..bitstream.sei import write_picture_hash_sei
                out += b"\x00\x00\x00\x01" + write_picture_hash_sei(
                    self.recon, bitdepth=self.cfg.bit_depth)
        return bytes(out)

    def _encode_frame(self, src_planes, poc, intra):
        cfg = self.cfg
        self._frame_base_qp = self.cur_qp
        self._pending_qp_delta = None
        from ..bitstream.sliceheader import SLICE_TYPE_B
        if intra:
            slice_type = SLICE_TYPE_I
        elif cfg.b_frames:
            slice_type = SLICE_TYPE_B
        else:
            slice_type = SLICE_TYPE_P
        if intra:
            nal_type = 21 if (cfg.use_cra and poc > 0) else 19  # CRA / IDR
        else:
            nal_type = 3 if (cfg.temporal_layers and (poc & 1)) else 1  # TSA_R / TRAIL_R
        tid = 1 if (cfg.temporal_layers and not intra and (poc & 1)) else 0
        if intra and nal_type == 19:
            self.dpb.clear_references()
            poc_out = 0
            self._poc_base = poc
        elif intra and nal_type == 21:
            # CRA: POC continues; past refs dropped from RPS (clean break)
            self.dpb.clear_references()
        poc_out = poc - getattr(self, "_poc_base", 0)

        frame = FramePlan(self.sps, self.pps, poc=poc_out)
        if cfg.temporal_layers:
            # TSA semantics (7.4.2.2): a TSA picture must not reference
            # any same-or-higher-tid picture preceding it, so BOTH tids
            # reference only the tid-0 (even-POC) pictures — the
            # adversarial ltr x tsa sweep caught tid-1 frames
            # referencing dropped tid-1 predecessors (round 4)
            n_refs_avail = sum(1 for p in self.dpb.pics
                               if p.state == SHORT_TERM and p.poc < poc_out
                               and (p.poc & 1) == 0)
        else:
            n_refs_avail = sum(1 for p in self.dpb.pics
                               if p.state == SHORT_TERM and p.poc < poc_out)
        n_refs = max(1, min(cfg.num_ref_l0, n_refs_avail)) if not intra else 0
        # long-term addition may raise the active count (set after ref calc)
        # slice header object for writer-side derivations
        hw = write_slice_header(cfg, nal_type, slice_type, poc_out,
                                num_neg_refs=n_refs or 1,
                                num_active=n_refs or 1)
        del hw  # per-slice headers are written in the slice loop
        from ..bitstream.sliceheader import SliceHeader
        sh = SliceHeader()
        sh.slice_type = slice_type
        sh.SliceQPY = self.cur_qp
        if intra:
            sh.initType = 0
        elif cfg.b_frames:
            sh.initType = 1 if cfg.cabac_init else 2
        else:
            sh.initType = 2 if cfg.cabac_init else 1
        sh.slice_segment_address = 0
        sh.SliceAddrRS = 0
        sh.MaxNumMergeCand = cfg.max_merge_cand
        sh.num_ref_idx_l0_active = n_refs or 1  # adjusted below if LTR
        sh.num_ref_idx_l1_active = (n_refs or 1) if (cfg.b_frames and not intra) else 0
        sh.slice_temporal_mvp_enabled_flag = 1 if (cfg.temporal_mvp and not intra) else 0
        sh.collocated_from_l0_flag = 1
        sh.collocated_ref_idx = 0
        sh.slice_sao_luma_flag = 1 if cfg.sao else 0
        sh.slice_sao_chroma_flag = 1 if (cfg.sao and
                                         cfg.chroma_format != 0) else 0
        sh.slice_deblocking_filter_disabled_flag = 1 if cfg.disable_deblocking else 0
        if cfg.weighted_pred and not intra:
            from ..bitstream.sliceheader import PredWeight
            pw = PredWeight()
            pw.luma_log2_weight_denom = cfg.luma_log2_weight_denom
            pw.chroma_log2_weight_denom = cfg.luma_log2_weight_denom
            for l in range(2):
                for r in range(cfg.num_ref_l0):
                    pw.luma_weight[l].append((1 << cfg.luma_log2_weight_denom)
                                             + cfg.luma_weight_delta)
                    pw.luma_offset[l].append(cfg.luma_offset)
                    pw.chroma_weight[l].append([1 << cfg.luma_log2_weight_denom] * 2)
                    pw.chroma_offset[l].append([0, 0])
            sh.pred_weight = pw

        # reference lists from DPB (most recent first, like our RPS writes)
        cand = [i for i, p in enumerate(self.dpb.pics)
                if p.state == SHORT_TERM and p.poc < poc_out]
        if cfg.temporal_layers:
            cand = [i for i in cand if (self.dpb.pics[i].poc & 1) == 0]
        lt_refs = []
        lt_pocs = []
        if cfg.use_ltr and not intra and poc_out >= 2:
            # IDR (poc 0) kept as long-term; ST refs exclude it
            lt0 = [i for i in cand if self.dpb.pics[i].poc == 0]
            if lt0:
                lt_refs = lt0[:1]
                lt_pocs = [0]
                cand = [i for i in cand if self.dpb.pics[i].poc != 0]
        refs = sorted(cand, key=lambda i: -self.dpb.pics[i].poc)[:max(1, n_refs)]
        ref_deltas = sorted(poc_out - self.dpb.pics[i].poc for i in refs) or None
        n_total = len(refs) + len(lt_refs)
        all_refs = refs + lt_refs
        lt_flags = [False] * len(refs) + [True] * len(lt_refs)
        if not intra and len(all_refs) > (n_refs or 1):
            sh.num_ref_idx_l0_active = len(all_refs)
            if cfg.b_frames:
                sh.num_ref_idx_l1_active = len(all_refs)
        self._list_mod = None
        if cfg.ref_list_reverse and not intra and n_total > 1:
            # ref_pic_lists_modification: reverse the RPS order; the
            # entries index the default list (7.3.6.2 / 8.3.4)
            entries = list(range(n_total))[::-1]
            all_refs = [all_refs[e] for e in entries]
            lt_flags = [lt_flags[e] for e in entries]
            self._list_mod = (n_total, entries)
        if cfg.b_frames and not intra:
            # generalized B: L1 = after(empty)+before = same past refs
            sh.RefPicList = [all_refs, list(all_refs)]
            sh.RefPOC = [[self.dpb.pics[i].poc for i in all_refs]] * 2
            sh.RefIsLongTerm = [list(lt_flags)] * 2
        else:
            sh.RefPicList = [all_refs, []]
            sh.RefPOC = [[self.dpb.pics[i].poc for i in all_refs], []]
            sh.RefIsLongTerm = [lt_flags, []]

        self.frame = frame
        self.src = src_planes
        self.recon = [np.zeros(p.shape, cfg.pix_dtype) for p in src_planes]
        self.avail = Availability(frame)
        self.motion = None if intra else MotionDeriver(
            _FakeDecoderCtx(self.dpb), frame, sh)

        if cfg.sao:
            self._decide_sao(frame)
        if cfg.rdo:
            from .rdo import RDOEmitter
            emitter = RDOEmitter(self, slice_type)
        else:
            emitter = _CUEmitter(self, slice_type)
        wc = self.sps.PicWidthInCtbsY
        hc = self.sps.PicHeightInCtbsY
        # partition CTB rows into slices
        nsl = max(1, min(cfg.num_slices, hc))
        rows_per = -(-hc // nsl)
        slice_row0 = list(range(0, hc, rows_per))
        nal = b""
        nals = []
        ts_to_rs = self.pps.CtbAddrTStoRS
        prev_ctx = None
        # WPP snapshots live across slice boundaries: a dependent slice
        # segment starting at a row start must inherit the row-above WPP
        # model, NOT the previous slice's continuation ctx (reference
        # decode_substream slice.cc:4679-4702 — the sync restore runs
        # whenever !first_independent_substream; width-1 pictures re-init,
        # slice.cc:4696-4703). Before round 5 the encoder continued
        # prev_ctx here, desyncing every conforming decoder (dec265
        # concealed "CTB outside of image area" on the wpp x dep vector).
        wpp_saved = {}
        for si, r0 in enumerate(slice_row0):
            r1 = min(r0 + rows_per, hc)
            seg_addr = r0 * wc
            dependent = cfg.dependent_slices and si > 0
            ssh = type(sh)()
            ssh.__dict__.update(sh.__dict__)
            ssh.slice_segment_address = seg_addr
            ssh.SliceAddrRS = 0 if dependent else seg_addr
            if cfg.mixed_filter_slices:
                # alternate per slice: even slices SAO-only (deblock off),
                # odd slices deblock-only (SAO off) — exercises the per-CTB
                # slice-header gating in the decoder's filters
                if si % 2 == 0:
                    ssh.slice_deblocking_filter_disabled_flag = 1
                    ssh.slice_sao_luma_flag = 1 if cfg.sao else 0
                    ssh.slice_sao_chroma_flag = 1 if (
                        cfg.sao and cfg.chroma_format != 0) else 0
                else:
                    ssh.slice_deblocking_filter_disabled_flag = 0
                    ssh.slice_sao_luma_flag = 0
                    ssh.slice_sao_chroma_flag = 0
            frame.slice_headers.append(ssh)
            if self.motion is not None:
                self.motion.sh = ssh
            slice_init_ctx = prev_ctx if dependent else None
            if dependent and cfg.wpp and r0 > 0:
                # dep segment at a WPP row start: decoders restore the
                # row-above model (or re-init when the picture is one
                # CTB wide) — mirror that so the emitted bins decode
                # back to the symbols we intended
                slice_init_ctx = None if wc == 1 else \
                    wpp_saved.get(r0 - 1, prev_ctx)
            sw = SliceWriter(frame, ssh, init_ctx=slice_init_ctx)
            emitter.sw = sw
            # CTBs of this slice in tile-scan order
            addrs = [rs for rs in (ts_to_rs[t] for t in range(wc * hc))
                     if r0 <= rs // wc < r1]
            for i, rs in enumerate(addrs):
                cx, cy = rs % wc, rs // wc
                if cfg.chroma_qp_offset_list:
                    # per-group (=CTB, diff depth 0) offset decision —
                    # fixed BEFORE any quantization in the group, emitted
                    # lazily at the first chroma-cbf TU
                    t = self._ctb_counter
                    self._ctb_counter += 1
                    flag = (t % 3) != 2
                    oidx = (t >> 1) % len(cfg.chroma_qp_offset_list) \
                        if flag else 0
                    self._chroma_off_next = (flag, oidx)
                    self._chroma_off_coded = False
                    self._cuc_qp_off = tuple(
                        cfg.chroma_qp_offset_list[oidx]) if flag else (0, 0)
                last_in_slice = (i == len(addrs) - 1)
                last_ctb = last_in_slice
                # substream boundary after this CTB?
                boundary = None
                if not last_in_slice:
                    nrs = addrs[i + 1]
                    if cfg.tiles and self.pps.TileId[nrs] != self.pps.TileId[rs]:
                        boundary = "tile"
                    elif cfg.wpp and (nrs % wc) == 0:
                        boundary = "row"
                sw.write_ctb(cx, cy, emitter, last_ctb,
                             end_substream=boundary is not None)
                if cfg.wpp and cx == 1:   # width-1 pictures never snapshot
                    wpp_saved[cy] = sw.snapshot_ctx()
                if boundary == "tile":
                    sw.start_substream(reinit=True)
                elif boundary == "row":
                    # width-1 pictures: decoders re-init the models per
                    # row (slice.cc:4696-4703) — emit with the same state
                    ncy = addrs[i + 1] // wc
                    sw.start_substream(
                        reinit=(wc == 1),
                        restore_ctx=None if wc == 1
                        else wpp_saved.get(ncy - 1))
            blobs = sw.finish()
            stuffed = [add_emulation_prevention(b) for b in blobs]
            entry_points = [len(b) for b in stuffed[:-1]]
            prev_ctx = sw.snapshot_ctx()
            hw2 = write_slice_header(cfg, nal_type, slice_type, poc_out,
                                     qp_delta=self.cur_qp - cfg.qp,
                                     first_ctb=seg_addr,
                                     num_neg_refs=n_refs or 1,
                                     num_active=(n_total if not intra and n_total
                                                 else (n_refs or 1)),
                                     entry_points=entry_points,
                                     dependent=dependent, tid=tid,
                                     ref_deltas=None if intra else ref_deltas,
                                     lt_pocs=lt_pocs if not intra else None,
                                     sao_flags=((ssh.slice_sao_luma_flag,
                                                 ssh.slice_sao_chroma_flag)
                                                if cfg.mixed_filter_slices else None),
                                     deblock_disabled=(
                                         ssh.slice_deblocking_filter_disabled_flag
                                         if cfg.mixed_filter_slices else None),
                                     list_mod=(None if intra
                                               else self._list_mod))
            payload = add_emulation_prevention(bytes(hw2.bytes)) + b"".join(stuffed)
            nals.append(payload)
        nal = None

        out_nals = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
        # in-loop filters on the reference reconstruction
        if not cfg.disable_deblocking:
            from ..ops.deblock_ref import deblock_frame
            deblock_frame(frame, self.recon)
        if cfg.sao:
            from ..ops.sao_ref import sao_frame
            self.recon = sao_frame(frame, self.recon)

        # store recon into DPB as reference
        frame.compress_motion()
        idx = self.dpb.new_picture(poc_out)
        pic = self.dpb.pics[idx]
        pic.planes = self.recon
        pic.plan = frame
        pic.needed_for_output = False
        # sliding-window eviction: every RPS this encoder writes only
        # references the most recent num_ref short-term pictures, so a
        # conformant decoder drops everything older after each frame —
        # mirror that here or long P chains overflow the DPB (kept
        # margin covers the temporal-layers even-POC reference pattern)
        from ..dpb import UNUSED
        nkeep = 2 * max(cfg.num_ref_l0, getattr(cfg, "num_ref_l1", 1)) + 2
        sts = sorted((p.poc for p in self.dpb.pics
                      if p.state == SHORT_TERM), reverse=True)
        keep = set(sts[:nkeep])
        for p in self.dpb.pics:
            if p.state == SHORT_TERM and p.poc not in keep:
                p.state = UNUSED
        return out_nals

    def _decide_sao(self, frame):
        """Deterministic per-CTB SAO parameters for stream generation."""
        k = 0
        for cy in range(frame.nctby):
            for cx in range(frame.nctbx):
                for ci in range(3):
                    t = (k + ci) % 3
                    frame.sao.type_idx[cy, cx, ci] = t
                    if t == 1:
                        frame.sao.band_pos[cy, cx, ci] = (k * 5 + ci * 7) % 29
                        frame.sao.offsets[cy, cx, ci] = [1 + (k % 3), -2, 3, -1]
                    elif t == 2:
                        frame.sao.eo_class[cy, cx, ci] = k % 4
                        frame.sao.offsets[cy, cx, ci] = [2, 1, -(k % 3), -2]
                k += 1
        # Cr shares type/eo_class with Cb (spec)
        frame.sao.type_idx[:, :, 2] = frame.sao.type_idx[:, :, 1]
        frame.sao.eo_class[:, :, 2] = frame.sao.eo_class[:, :, 1]

    # --------------------------------------------------------------- CUs
    def _emit_intra_cu(self, sw, x0, y0, log2_size, depth, idx,
                       header_done=False, mode=None):
        cfg = self.cfg
        if not header_done:
            if sw.sh.slice_type != SLICE_TYPE_I:
                sw.write_skip_flag(x0, y0, False)
                sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTRA, False)
                sw.write_pred_mode(True)
            else:
                sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTRA, False)
        sw_c, sh_c = self.sps.SubWidthC, self.sps.SubHeightC
        cat = self.sps.ChromaArrayType
        if cfg.pcm and idx % 5 == 0 and 3 <= log2_size <= 5:
            sw.write_part_mode_intra(log2_size, PART_2Nx2N)
            n = 1 << log2_size
            ys = self.src[0][y0:y0 + n, x0:x0 + n]
            if cat != 0:
                cx0, cy0 = x0 // sw_c, y0 // sh_c
                cw_, ch_ = n // sw_c, n // sh_c
                cb = self.src[1][cy0:cy0 + ch_, cx0:cx0 + cw_]
                cr = self.src[2][cy0:cy0 + ch_, cx0:cx0 + cw_]
            else:
                cb = cr = np.zeros((0, 0), self.cfg.pix_dtype)
            sw.write_pcm(x0, y0, log2_size, ys, cb, cr, cfg.bit_depth)
            # recon = raw samples (lossless)
            self.recon[0][y0:y0 + n, x0:x0 + n] = ys
            if cat != 0:
                self.recon[1][cy0:cy0 + ch_, cx0:cx0 + cw_] = cb
                self.recon[2][cy0:cy0 + ch_, cx0:cx0 + cw_] = cr
            # intra-mode grids: PCM blocks expose DC for MPM purposes
            gs = n >> 2
            self.frame.intra_mode_y[y0 >> 2:(y0 >> 2) + gs,
                                    x0 >> 2:(x0 >> 2) + gs] = 1
            self.frame.intra_mode_c[y0 >> 2:(y0 >> 2) + gs,
                                    x0 >> 2:(x0 >> 2) + gs] = 1
            return
        if cfg.nxn_intra and log2_size == 3:
            self._emit_intra_nxn_cu(sw, x0, y0, idx)
            return
        if mode is None:
            if cfg.intra_mode_sel == "minsad":
                mode = self._pick_intra_mode(x0, y0, log2_size)
            else:
                mode = cfg.intra_modes[idx % len(cfg.intra_modes)]
        sw.write_part_mode_intra(log2_size, PART_2Nx2N)
        if cfg.pcm and 3 <= log2_size <= 5:
            sw.cabac.encode_terminate(0)   # pcm_flag = 0
        sw.write_intra_modes(x0, y0, log2_size, [mode])

        # predict + residual on luma and both chroma planes
        n = 1 << log2_size
        coeffs_y = self._intra_predict_and_quant(0, x0, y0, log2_size, mode)
        y_rext = (self._last_ts, self._last_rdpcm, self._last_rot)
        cbf_y = coeffs_y is not None
        if cat == 0:
            sw.write_cbf_luma(True, cbf_y)
            sw.record_tu(x0, y0, log2_size, cbf_y)
            if cbf_y:
                self._maybe_write_qp_delta(sw)
                sw.write_residual(coeffs_y, log2_size,
                                  0, self._scan_for(mode, log2_size, 0),
                                  ts=y_rext[0])
            self._recon_intra(0, x0, y0, log2_size, mode, coeffs_y,
                              ts=y_rext[0], rdpcm=y_rext[1],
                              rotate=y_rext[2])
            return
        # chroma geometry per format; 4:2:2 codes two stacked TBs per
        # plane and remaps the derived (DM) mode through Table 8-23
        from ..bitstream.ctu import MAP_CHROMA_422
        cmode = MAP_CHROMA_422[mode] if cat == 2 else mode
        clog2 = log2_size if cat == 3 else log2_size - 1
        cx, cy_ = x0 // sw_c, y0 // sh_c
        n_tb = 2 if cat == 2 else 1
        # cross-component prediction (range ext, 4:4:4, derived chroma
        # mode — always "mode 4" for this encoder): deterministic alpha
        # cycle per CU; the chroma residual is coded MINUS the scaled
        # luma residual, the decoder adds it back (transform.cc:235-251)
        ccp = self.cfg.cross_comp_pred and cat == 3 and cbf_y
        alphas = {1: 0, 2: 0}
        ccp_terms = {}
        if ccp:
            cyc = (1, -2, 4, 0, -8, 2, -1, 8)
            alphas[1] = cyc[idx % len(cyc)]
            alphas[2] = cyc[(idx + 3) % len(cyc)]
            res_l = self._residual_from_coeffs(
                0, log2_size, coeffs_y, y_rext[0], y_rext[1], y_rext[2])
            bd_c = bd_y = self.cfg.bit_depth
            rl = ((res_l.astype(np.int64) << bd_c) >> bd_y)
            for ci in (1, 2):
                ccp_terms[ci] = (alphas[ci] * rl) >> 3
        # quantize + reconstruct chroma TB-sequentially (the 4:2:2 bottom
        # TB predicts from the top TB's reconstruction), then write the
        # bitstream in syntax order (all cbf flags precede residuals)
        cco = {}
        crext = {}
        for ci in (1, 2):
            for tb in range(n_tb):
                yc = cy_ + (tb << clog2)
                cco[ci, tb] = self._intra_predict_and_quant(
                    ci, cx, yc, clog2, cmode, defer=True,
                    ccp_sub=ccp_terms.get(ci) if alphas[ci] else None)
                crext[ci, tb] = (self._last_ts, self._last_rdpcm,
                                 self._last_rot)
                self._recon_intra(
                    ci, cx, yc, clog2, cmode, cco[ci, tb],
                    ts=crext[ci, tb][0], rdpcm=crext[ci, tb][1],
                    rotate=crext[ci, tb][2],
                    ccp_add=ccp_terms.get(ci) if alphas[ci] else None)
        # transform tree: no split (maxdepth 0, log2<=MaxTb); the 4:2:2
        # second cbf bit follows the first at non-split nodes
        for ci in (1, 2):
            for tb in range(n_tb):
                sw.write_cbf_chroma(0, cco[ci, tb] is not None)
        sw.write_cbf_luma(True, cbf_y)
        sw.record_tu(x0, y0, log2_size, cbf_y)
        any_chroma = any(v is not None for v in cco.values())
        if cbf_y or any_chroma:
            self._maybe_write_qp_delta(sw)
            self._maybe_write_chroma_qp_offset(sw, any_chroma)
        if cbf_y:
            sw.write_residual(coeffs_y, log2_size,
                              0, self._scan_for(mode, log2_size, 0),
                              ts=y_rext[0])
        self._recon_intra(0, x0, y0, log2_size, mode, coeffs_y,
                          ts=y_rext[0], rdpcm=y_rext[1], rotate=y_rext[2])
        for ci in (1, 2):
            if ccp:
                sw.write_cross_comp(ci, alphas[ci])
            for tb in range(n_tb):
                if cco[ci, tb] is not None:
                    sw.write_residual(cco[ci, tb], clog2, ci,
                                      self._scan_for(cmode, clog2, ci),
                                      ts=crext[ci, tb][0])

    def _emit_intra_nxn_cu(self, sw, x0, y0, idx):
        """8x8 PART_NxN intra CU: 4 luma modes + forced TT split
        (intra_split), the path that exercises blk3 chroma aggregation,
        the 4:2:2 dual cbf at a log2==3 split, and 4:4:4 per-leaf cbf
        (slice.cc:3884-3902, 3745-3790). Caller wrote the CU header."""
        cfg = self.cfg
        sps = self.sps
        cat = sps.ChromaArrayType
        assert not cfg.cu_qp_delta and not cfg.pcm
        from ..plan import PART_NxN
        from ..bitstream.ctu import MAP_CHROMA_422
        sw.write_part_mode_intra(3, PART_NxN)
        base = idx % len(cfg.intra_modes)
        modes = [cfg.intra_modes[(base + k) % len(cfg.intra_modes)]
                 for k in range(4)]
        sw.write_intra_modes_nxn(x0, y0, 3, modes)
        cmode_cu = MAP_CHROMA_422[modes[0]] if cat == 2 else modes[0]

        # depth0 chroma cbf (forced-split log2==3 node). 4:2:0/4:2:2:
        # these ARE the final flags for the blk3 chroma TBs — compute the
        # coefficients now (their prediction only reads neighbor CUs,
        # plus the top TB for the 4:2:2 bottom one). 4:4:4: parent=1,
        # the per-leaf flags decide.
        cco = {}
        ctsb = {}
        if cat in (1, 2):
            cx, cy_ = x0 // sps.SubWidthC, y0 // sps.SubHeightC
            n_tb = 2 if cat == 2 else 1
            for ci in (1, 2):
                for tb in range(n_tb):
                    yc = cy_ + (tb << 2)
                    cco[ci, tb] = self._intra_predict_and_quant(
                        ci, cx, yc, 2, cmode_cu)
                    ctsb[ci, tb] = self._last_ts
                    self._recon_intra(ci, cx, yc, 2, cmode_cu, cco[ci, tb],
                                      ts=ctsb[ci, tb])
            for ci in (1, 2):
                for tb in range(n_tb):
                    sw.write_cbf_chroma(0, cco[ci, tb] is not None)
        elif cat == 3:
            sw.write_cbf_chroma(0, True)
            sw.write_cbf_chroma(0, True)

        # 4 TT leaves (depth 1, log2==2), z-order
        for i in range(4):
            px, py = x0 + (i & 1) * 4, y0 + (i >> 1) * 4
            mode = modes[i]
            if cat == 3:
                ccoef = {}
                ctsl = {}
                for ci in (1, 2):
                    ccoef[ci] = self._intra_predict_and_quant(
                        ci, px, py, 2, mode)
                    ctsl[ci] = self._last_ts
                sw.write_cbf_chroma(1, ccoef[1] is not None)
                sw.write_cbf_chroma(1, ccoef[2] is not None)
            cy_coeffs = self._intra_predict_and_quant(0, px, py, 2, mode)
            yts = self._last_ts
            sw.write_cbf_luma(False, cy_coeffs is not None)
            sw.record_tu(px, py, 2, cy_coeffs is not None)
            if cy_coeffs is not None:
                sw.write_residual(cy_coeffs, 2, 0,
                                  self._scan_for(mode, 2, 0), ts=yts)
            self._recon_intra(0, px, py, 2, mode, cy_coeffs, ts=yts)
            if cat == 3:
                for ci in (1, 2):
                    if ccoef[ci] is not None:
                        sw.write_residual(ccoef[ci], 2, ci,
                                          self._scan_for(mode, 2, ci),
                                          ts=ctsl[ci])
                    self._recon_intra(ci, px, py, 2, mode, ccoef[ci],
                                      ts=ctsl[ci])
            elif cat in (1, 2) and i == 3:
                for ci in (1, 2):
                    for tb in range(2 if cat == 2 else 1):
                        if cco[ci, tb] is not None:
                            sw.write_residual(cco[ci, tb], 2, ci,
                                              self._scan_for(cmode_cu, 2, ci),
                                              ts=ctsb[ci, tb])

    def _apply_sdh(self, q, log2, scan_idx):
        """Sign-data-hiding parity normalization: for every 4x4 coded
        sub-block whose scan span exceeds 3, make (sum of |levels|) & 1
        encode the first-in-scan coefficient's sign (bump the last
        coefficient's magnitude by one when the parity disagrees — keeps
        every significance position intact). Mirror of the reader's
        inference (ctu.py) / spec 7.4.9.11."""
        if q is None or not self.cfg.sign_data_hiding:
            return q
        from ..bitstream.scan import get_scan_order
        c_scan = get_scan_order(4, scan_idx)
        n = 1 << log2
        for sy in range(n >> 2):
            for sx in range(n >> 2):
                blk = q[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
                pos = [i for i, (x, y) in enumerate(c_scan) if blk[y, x]]
                if not pos or pos[-1] - pos[0] <= 3:
                    continue
                fx, fy = c_scan[pos[0]]
                desired = 1 if blk[fy, fx] < 0 else 0
                parity = int(np.abs(blk).sum()) & 1
                if parity != desired:
                    lx_, ly_ = c_scan[pos[-1]]
                    blk[ly_, lx_] += 1 if blk[ly_, lx_] > 0 else -1
        return q

    def _scan_for(self, mode, log2, cidx):
        sps = self.sps
        if log2 == 2 or (log2 == 3 and
                         (cidx == 0 or sps.ChromaArrayType == 3)):
            if 6 <= mode <= 14:
                return SCAN_VERT
            if 22 <= mode <= 30:
                return SCAN_HORIZ
        return SCAN_DIAG

    def _qp_for(self, cidx):
        from ..bitstream.ctu import chroma_qp_from_luma
        bd_off = 6 * (self.cfg.bit_depth - 8)
        if cidx == 0:
            return self.cur_qp + bd_off
        off = self.cfg.cb_qp_offset if cidx == 1 else self.cfg.cr_qp_offset
        if self.cfg.chroma_qp_offset_list:
            off += self._cuc_qp_off[cidx - 1]
        qpi = max(-bd_off, min(57, self.cur_qp + off))
        return chroma_qp_from_luma(qpi, self.sps.ChromaArrayType) + bd_off

    # basis-projection quantization ------------------------------------
    def _smat(self, log2, cidx, is_intra):
        if not self.cfg.scaling_lists:
            return None, None
        return transform_ref.scaling_matrix(self.sps.scaling_list, log2,
                                            cidx, is_intra)

    def _basis(self, log2, qp, is_dst, cidx=0, is_intra=True, tskip=False):
        key = (log2, qp, is_dst, cidx if self.cfg.scaling_lists else 0,
               is_intra if self.cfg.scaling_lists else True,
               self.cfg.bit_depth, tskip)
        if key in self._basis_cache:
            return self._basis_cache[key]
        n = 1 << log2
        smat, sdc = self._smat(log2, cidx, is_intra)
        # ANALYTIC float basis: the decoder's linear map without its
        # integer roundings. Unit-impulse responses round each stage to
        # ints — at low QP a high-frequency unit's true response is
        # fractional (<1) and rounds to 0/±1 garbage, so projecting onto
        # rounded responses picks wrong levels and quality DEGRADES as QP
        # drops (the round-2 RD anchor's 13 dB anchor). The decoder's own
        # roundings on the real level vector are O(1) and harmless.
        bd = self.cfg.bit_depth
        bd_shift = bd + log2 - 5
        ls = transform_ref.LEVEL_SCALE[qp % 6]
        if smat is None:
            fac = np.full((n, n), float((16 * ls) << (qp // 6)))
        else:
            m = smat.astype(np.float64)
            if sdc is not None:
                m = m.copy()
                m[0, 0] = sdc
            fac = m * ls * (1 << (qp // 6))
        fac = fac / (1 << bd_shift)            # dequant scale per coeff
        if tskip:
            resp_scale = fac * (1 << 7) / (1 << (20 - bd))
            flat = np.diag(resp_scale.ravel())
        else:
            mat = (transform_ref.DST4 if is_dst
                   else transform_ref.dct_matrix(n)).astype(np.float64)
            # r = M^T d M: unit at (ky,kx) -> outer(M[ky,:], M[kx,:])
            sc = 1.0 / (1 << 7) / (1 << (20 - bd))
            flat = np.empty((n * n, n * n))
            for ky in range(n):
                for kx in range(n):
                    flat[ky * n + kx] = (np.outer(mat[ky], mat[kx]) *
                                         (fac[ky, kx] * sc)).ravel()
        norms = (flat * flat).sum(1)
        norms[norms == 0] = 1.0
        self._basis_cache[key] = (flat, norms)
        return flat, norms

    def _quantize(self, residual, log2, qp, is_dst, cidx=0, is_intra=True,
                  tskip=False):
        """Project residual onto decoder impulse-response basis -> levels."""
        n = 1 << log2
        flat, norms = self._basis(log2, qp, is_dst, cidx, is_intra, tskip)
        proj = flat @ residual.astype(np.float64).ravel() / norms
        levels = np.round(proj).astype(np.int32).reshape(n, n)
        return np.clip(levels, -32767, 32767)

    def _pick_intra_mode(self, x0, y0, log2):
        """Content-adaptive luma mode: min SAD of prediction vs source
        over a planar/DC/angular sweep (chroma follows via DM). The
        prediction reads the SAME recon neighbors the emit path will,
        so the choice is exact."""
        n = 1 << log2
        src = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int32)
        best, bm = None, 0
        for m in (0, 1) + tuple(range(2, 35, 2)) + (26, 10):
            pred = self._intra_pred(0, x0, y0, log2, m)
            sad = int(np.abs(src - pred).sum())
            if best is None or sad < best:
                best, bm = sad, m
        return bm

    def _maybe_write_qp_delta(self, sw):
        """Write the pending cu_qp_delta at the first coded-cbf TU of
        the CU (reader: transform_unit after the cbf flags)."""
        if self.cfg.cu_qp_delta and self._pending_qp_delta is not None:
            sw.write_cu_qp_delta(self._pending_qp_delta)
            self._pending_qp_delta = None

    def _maybe_write_chroma_qp_offset(self, sw, has_chroma_cbf):
        """TU-level chroma QP offset (range ext): signalled at the first
        chroma-cbf TU of each group (= CTB with diff depth 0); the
        per-group decision was fixed at CTB start so quantization already
        used it (reader: slice.cc:3610-3635)."""
        if not self.cfg.chroma_qp_offset_list or not has_chroma_cbf:
            return
        if getattr(self, "_cur_bypass", False) or self._chroma_off_coded:
            return
        flag, oidx = self._chroma_off_next
        sw.write_cu_chroma_qp_offset(flag, oidx)
        self._chroma_off_coded = True

    def _tskip_for(self, x, y, log2):
        """Deterministic per-TU transform-skip choice for 4x4 TUs when
        the config enables it (vector generation: alternate by position)."""
        return bool(self.cfg.transform_skip) and log2 == 2 and \
            (((x >> 2) + (y >> 2)) & 1) == 1

    def _rext_intra(self, mode, ts):
        """(rdpcm, rotate) for an intra TU given the configured range-ext
        tools (mirrors decode_TU, slice.cc:3446-3455, and the rotation
        gate, transform.cc:395-397)."""
        byp = getattr(self, "_cur_bypass", False)
        rdpcm = 0
        if self.cfg.implicit_rdpcm and (byp or ts) and mode in (10, 26):
            rdpcm = 1 if mode == 10 else 2
        rotate = self.cfg.tskip_rotation and (byp or ts)
        return rdpcm, rotate

    def _intra_predict_and_quant(self, cidx, x, y, log2, mode, defer=False,
                                 ccp_sub=None):
        """Returns the EMITTED coeff array or None if all-zero. Prediction
        uses the current recon (neighbors already reconstructed in
        z-order). Sets self._last_ts / _last_rdpcm / _last_rot.
        ccp_sub: cross-component predictor ((alpha*resL')>>3) already
        scaled — subtracted from the residual before quantization."""
        pred = self._intra_pred(cidx, x, y, log2, mode)
        n = 1 << log2
        src = self.src[cidx][y:y + n, x:x + n].astype(np.int32)
        residual = src - pred
        if ccp_sub is not None:
            residual = residual - ccp_sub
        self._last_ts = False
        self._last_rdpcm = 0
        self._last_rot = False
        if getattr(self, "_cur_bypass", False):
            rdpcm, rotate = self._rext_intra(mode, False)
            rotate = rotate and log2 == 2
            q = np.clip(residual, -32767, 32767).astype(np.int64)
            if rdpcm == 1:
                q = np.diff(q, axis=1, prepend=0)
            elif rdpcm == 2:
                q = np.diff(q, axis=0, prepend=0)
            q = np.clip(q, -32767, 32767).astype(np.int32)
            if rotate:
                q = q[::-1, ::-1].copy()
            self._last_rdpcm, self._last_rot = rdpcm, rotate
            return q if q.any() else None
        ts = self._tskip_for(x, y, log2)
        rdpcm, rotate = self._rext_intra(mode, ts)
        rotate = rotate and ts and log2 == 2
        is_dst = (cidx == 0 and log2 == 2 and not ts)
        if rdpcm and ts:
            # DPCM the residual, quantize the differences; the closed
            # loop recon runs the decoder-exact cumsum path
            d = np.diff(residual.astype(np.int64), axis=2 - rdpcm,
                        prepend=0)
            q = self._quantize(d.astype(np.int32), log2,
                               self._qp_for(cidx), False, cidx,
                               True, tskip=True)
        else:
            rdpcm = 0
            q = self._quantize(residual, log2, self._qp_for(cidx), is_dst,
                               cidx, True, tskip=ts)
        if rotate:
            q = q[::-1, ::-1].copy()
        if not q.any():
            self._last_rot = False
            return None
        self._last_ts = ts
        self._last_rdpcm, self._last_rot = rdpcm, rotate
        return self._apply_sdh(q, log2, self._scan_for(mode, log2, cidx))

    def _intra_pred(self, cidx, x, y, log2, mode):
        n = 1 << log2
        bd = self.cfg.bit_depth
        ref = gather_border(self.frame, self.recon, self.avail, x, y, log2,
                            cidx, bd)
        if self.cfg.intra_smoothing_disabled:
            fref = ref     # range ext: no smoothing (intrapred.cc:1085)
        else:
            fref = intra_ref.filter_border(
                ref, n, mode, cidx, bd,
                bool(self.cfg.strong_intra_smoothing),
                c444=self.sps.ChromaArrayType == 3)
        dbf = self.cfg.implicit_rdpcm and getattr(self, "_cur_bypass", False)
        return intra_ref.predict(fref, mode, log2, cidx, bd,
                                 disable_boundary_filter=dbf)

    def _residual_from_coeffs(self, cidx, log2, coeffs, ts, rdpcm=0,
                              rotate=False, is_intra=True):
        """Decoder-exact residual from emitted coeffs (the closed loop)."""
        is_dst = (cidx == 0 and log2 == 2 and is_intra and not ts)
        smat, sdc = self._smat(log2, cidx, is_intra)
        if getattr(self, "_cur_bypass", False):
            smat = sdc = None
        return transform_ref.scale_and_inv_transform(
            coeffs, self._qp_for(cidx), log2, is_dst, ts,
            getattr(self, "_cur_bypass", False) and True,
            self.cfg.bit_depth, smat, sdc, rdpcm=rdpcm, rotate=rotate)

    def _recon_intra(self, cidx, x, y, log2, mode, coeffs, ts=False,
                     rdpcm=0, rotate=False, ccp_add=None):
        pred = self._intra_pred(cidx, x, y, log2, mode)
        n = 1 << log2
        if coeffs is not None or ccp_add is not None:
            if coeffs is not None:
                res = self._residual_from_coeffs(cidx, log2, coeffs, ts,
                                                 rdpcm, rotate)
            else:
                res = np.zeros((n, n), np.int64)
            if ccp_add is not None:
                res = res + ccp_add
            out = np.clip(pred + res, 0, self.cfg.maxval)
        else:
            out = np.clip(pred, 0, self.cfg.maxval)
        self.recon[cidx][y:y + n, x:x + n] = out.astype(self.cfg.pix_dtype)

    # ----------------------------------------------------------- inter CUs
    def _emit_skip_cu(self, sw, x0, y0, log2_size, depth, idx,
                      merge_idx=None):
        sw.write_skip_flag(x0, y0, True)
        sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTER, True)
        n_cand = self.cfg.max_merge_cand
        if merge_idx is None:
            merge_idx = idx % n_cand
        sw.write_merge_idx(merge_idx)
        size = 1 << log2_size
        self.motion.decode_merge(sw, x0, y0, x0, y0, size, size, 0,
                                 PART_2Nx2N, depth, merge_idx)
        self._recon_inter_pu(self.frame.pus[-1])
        sw.record_tu(x0, y0, log2_size, False)

    def _emit_mv_cu(self, sw, x0, y0, log2_size, depth, idx, with_residual,
                    dec=None):
        cfg = self.cfg
        from ..bitstream.sliceheader import SLICE_TYPE_B
        sw.write_skip_flag(x0, y0, False)
        sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTER, False)
        sw.write_pred_mode(False)
        sw.write_part_mode_inter_2nx2n(log2_size)
        # prediction unit: explicit MV (no merge)
        sw.write_merge_flag(False)
        size = 1 << log2_size
        is_b = sw.sh.slice_type == SLICE_TYPE_B
        if dec is not None:          # RDO-chosen motion (rdo.py LeafDec)
            inter_dir = dec.inter_dir
        else:
            inter_dir = (0, 2, 1, 2)[idx % 4] if is_b else 0  # L0/BI/L1/BI
        if is_b:
            sw.write_inter_pred_idc(inter_dir, size, size, depth)
        n_act0 = sw.sh.num_ref_idx_l0_active
        n_act1 = sw.sh.num_ref_idx_l1_active
        if dec is not None:
            mvd0, mvd1 = dec.mvd, (0, 0)
            ref_idx, ref1 = dec.ref_idx, 0
        else:
            mvd0 = cfg.mv_patterns[idx % len(cfg.mv_patterns)]
            mvd1 = cfg.mv_patterns[(idx + 3) % len(cfg.mv_patterns)]
            ref_idx = idx % n_act0
            ref1 = idx % n_act1 if n_act1 else 0
        if inter_dir != 1:
            sw.write_ref_idx(ref_idx, n_act0)
            sw.write_mvd(mvd0)
            sw.write_mvp_flag(0)
        if inter_dir != 0:
            sw.write_ref_idx(ref1, n_act1)
            if cfg.mvd_l1_zero and inter_dir == 2:
                mvd1 = (0, 0)     # inferred zero, not coded (7.3.8.6)
            else:
                sw.write_mvd(mvd1)
            sw.write_mvp_flag(0)
        self.motion.decode_amvp(sw, x0, y0, x0, y0, size, size, 0, PART_2Nx2N,
                                depth, inter_dir, [ref_idx, ref1],
                                [mvd0 if inter_dir != 1 else (0, 0),
                                 mvd1 if inter_dir != 0 else (0, 0)], [0, 0])
        pu = self.frame.pus[-1]
        pred = self._recon_inter_pu(pu, write=False)
        if with_residual and log2_size > cfg.log2_max_tb:
            # CU larger than the max TB: the transform tree splits
            # (inferred, log2 > MaxTbLog2 — no split flag), the only
            # syntax shape that exercises the inter split-TT paths
            self._emit_inter_tt_split(sw, x0, y0, log2_size, pred)
            return
        coeffs = None
        rdpcm = 0
        if with_residual:
            src = self.src[0][y0:y0 + size, x0:x0 + size].astype(np.int32)
            residual = src - pred[0]
            byp0 = getattr(self, "_cur_bypass", False)
            if byp0 and cfg.explicit_rdpcm:
                # explicit RDPCM (range ext) on lossless inter CUs:
                # deterministic direction cycle (none/h/v); coeffs are
                # the DPCM differences (transform.cc:549-560).
                # (_cur_bypass is idx%3==0, so cycle on idx//3.)
                rdpcm = (idx // 3) % 3
            if byp0:
                r = np.clip(residual, -32767, 32767).astype(np.int64)
                if rdpcm == 1:
                    r = np.diff(r, axis=1, prepend=0)
                elif rdpcm == 2:
                    r = np.diff(r, axis=0, prepend=0)
                coeffs = np.clip(r, -32767, 32767).astype(np.int32)
            else:
                coeffs = self._quantize(residual, log2_size, self._qp_for(0),
                                        False, 0, False)
            if not coeffs.any():
                coeffs = None
                rdpcm = 0
            coeffs = self._apply_sdh(coeffs, log2_size, SCAN_DIAG)
        # rqt_root_cbf (merge==0 -> always present)
        sw.write_rqt_root_cbf(coeffs is not None)
        sw.record_tu(x0, y0, log2_size, coeffs is not None)
        if coeffs is not None:
            # transform tree, no split; chroma cbf 0 (4:2:2 codes two
            # flags per plane at a non-split node), luma inferred 1
            cat = self.sps.ChromaArrayType
            if cat != 0:
                for _ in range(2 * (2 if cat == 2 else 1)):
                    sw.write_cbf_chroma(0, False)
            self._maybe_write_qp_delta(sw)
            sw.write_residual(coeffs, log2_size, 0, SCAN_DIAG,
                              inter=True, rdpcm=rdpcm)
            byp = getattr(self, "_cur_bypass", False)
            res = self._residual_from_coeffs(0, log2_size, coeffs, False,
                                             rdpcm, False, is_intra=False)
            out = np.clip(pred[0] + res, 0, self.cfg.maxval)
            dt = self.cfg.pix_dtype
            self.recon[0][y0:y0 + size, x0:x0 + size] = out.astype(dt)
            sw_, sh2 = self.sps.SubWidthC, self.sps.SubHeightC
            cpred = [None, pred[1], pred[2]]
            if cat == 3 and cfg.cross_comp_pred:
                # the decoder reads cross-comp syntax for every inter TU
                # with cbf_luma (even with chroma cbf 0) and ADDS the
                # scaled luma residual to the chroma planes
                cyc = (0, 1, -4, 2, 0, -1, 8, -2)
                rl = res.astype(np.int64)   # equal bit depths: shifts cancel
                for ci in (1, 2):
                    alpha = cyc[(idx + ci) % len(cyc)]
                    sw.write_cross_comp(ci, alpha)
                    if alpha:
                        cpred[ci] = np.clip(
                            pred[ci].astype(np.int64) + ((alpha * rl) >> 3),
                            0, self.cfg.maxval)
            self.recon[1][y0 // sh2:(y0 + size) // sh2,
                          x0 // sw_:(x0 + size) // sw_] = cpred[1].astype(dt)
            self.recon[2][y0 // sh2:(y0 + size) // sh2,
                          x0 // sw_:(x0 + size) // sw_] = cpred[2].astype(dt)
        else:
            dt = self.cfg.pix_dtype
            self.recon[0][y0:y0 + size, x0:x0 + size] = pred[0].astype(dt)
            sw_, sh2 = self.sps.SubWidthC, self.sps.SubHeightC
            for ci in (1, 2):
                self.recon[ci][y0 // sh2:(y0 + size) // sh2,
                               x0 // sw_:(x0 + size) // sw_] = pred[ci].astype(dt)

    def _emit_2pu_cu(self, sw, x0, y0, log2_size, depth, idx):
        """Inter CU with TWO prediction units (2NxN/Nx2N, or the four AMP
        shapes when sps.amp_enabled_flag): each PU codes explicit AMVP
        motion. Exercises the multi-PU decode paths (part_geometry,
        per-PU merge/AMVP with partition-dependent candidate rules) that
        no 2Nx2N stream reaches. No residual (rqt_root_cbf = 0)."""
        from ..plan import (PART_2NxN, PART_Nx2N, PART_2NxnU, PART_2NxnD,
                            PART_nLx2N, PART_nRx2N)
        from ..bitstream.ctu import part_geometry
        cfg = self.cfg
        modes = ((PART_2NxN, PART_Nx2N, PART_2NxnU, PART_2NxnD,
                  PART_nLx2N, PART_nRx2N) if cfg.amp
                 else (PART_2NxN, PART_Nx2N))
        part_mode = modes[idx % len(modes)]
        sw.write_skip_flag(x0, y0, False)
        sw.cu_metadata(x0, y0, log2_size, depth, MODE_INTER, False)
        sw.write_pred_mode(False)
        sw.write_part_mode_inter(log2_size, part_mode)
        size = 1 << log2_size
        n_act0 = sw.sh.num_ref_idx_l0_active
        # odd CUs: the second PU codes MERGE (exercises the partIdx-1
        # candidate exclusions A1/B1, 8.5.3.2.3)
        pu1_merge = cfg.two_pu_merge and (idx & 1)
        for pi, (dx, dy, w, h) in enumerate(part_geometry(part_mode, size)):
            px, py = x0 + dx, y0 + dy
            if pu1_merge and pi == 1:
                midx = idx % min(cfg.max_merge_cand, 3)
                sw.write_merge_flag(True)
                sw.write_merge_idx(midx)
                self.motion.decode_merge(sw, x0, y0, px, py, w, h, pi,
                                         part_mode, depth, midx)
            else:
                mvd = cfg.mv_patterns[(idx * 2 + pi) % len(cfg.mv_patterns)]
                ref_idx = (idx + pi) % n_act0
                sw.write_merge_flag(False)
                sw.write_ref_idx(ref_idx, n_act0)
                sw.write_mvd(mvd)
                sw.write_mvp_flag(pi & 1)
                self.motion.decode_amvp(sw, x0, y0, px, py, w, h, pi,
                                        part_mode, depth, 0,
                                        [ref_idx, 0], [mvd, (0, 0)],
                                        [pi & 1, 0])
            self._recon_inter_pu(self.frame.pus[-1], write=True)
        sw.write_rqt_root_cbf(False)

    def _emit_inter_tt_split(self, sw, x0, y0, log2_size, pred):
        """Inter CU with a split transform tree (log2CU > Log2MaxTrafoSize):
        4 luma TBs at log2-1, chroma TBs per leaf. Mirrors the reader's
        inferred-split path (slice.cc:3849-3856: no split flag when
        log2TrafoSize > MaxTbLog2SizeY)."""
        cfg = self.cfg
        sps = self.sps
        cat = sps.ChromaArrayType
        assert cat in (0, 1), "inter TT-split emission: 4:2:0/mono only"
        # single-level split only: leaves at log2-1 (>= 8x8 luma)
        assert log2_size >= 4 and cfg.log2_max_tb == log2_size - 1, \
            "inter TT-split emission: one split level (log2_max_tb = CU-1)"
        half = 1 << (log2_size - 1)
        clog2 = log2_size - 2
        sw_c, sh_c = sps.SubWidthC, sps.SubHeightC
        dt = cfg.pix_dtype
        maxv = cfg.maxval

        # quantize every leaf's luma + chroma residual first (cbf flags
        # precede all residual data in each subtree, and the depth-0
        # chroma gates precede everything)
        ly, lc, lts = {}, {}, {}
        for i in range(4):
            px, py = x0 + (i & 1) * half, y0 + (i >> 1) * half
            src = self.src[0][py:py + half, px:px + half].astype(np.int32)
            rsd = src - pred[0][py - y0:py - y0 + half, px - x0:px - x0 + half]
            lts[i] = self._tskip_for(px, py, log2_size - 1)
            q = self._quantize(rsd, log2_size - 1, self._qp_for(0), False,
                               0, False, tskip=lts[i])
            q = self._apply_sdh(q, log2_size - 1, SCAN_DIAG)
            ly[i] = q if q.any() else None
            if ly[i] is None:
                lts[i] = False
            if cat != 0:
                cx, cy = px // sw_c, py // sh_c
                cw_, ch_ = half // sw_c, half // sh_c
                for ci in (1, 2):
                    srcc = self.src[ci][cy:cy + ch_, cx:cx + cw_] \
                        .astype(np.int32)
                    pc = pred[ci][cy - y0 // sh_c:cy - y0 // sh_c + ch_,
                                  cx - x0 // sw_c:cx - x0 // sw_c + cw_]
                    qc = self._quantize(srcc - pc, clog2,
                                        self._qp_for(ci), False, ci, False)
                    qc = self._apply_sdh(qc, clog2, SCAN_DIAG)
                    lc[i, ci] = qc if qc.any() else None
        any_cb = any(lc.get((i, 1)) is not None for i in range(4))
        any_cr = any(lc.get((i, 2)) is not None for i in range(4))

        sw.write_rqt_root_cbf(True)
        # depth-0 chroma cbf gates (log2 > 2; no split flag — inferred)
        if cat != 0:
            sw.write_cbf_chroma(0, any_cb)
            sw.write_cbf_chroma(0, any_cr)
        # 4 leaves at depth 1 in z-order
        for i in range(4):
            px, py = x0 + (i & 1) * half, y0 + (i >> 1) * half
            ccb = lc.get((i, 1))
            ccr = lc.get((i, 2))
            if cat != 0:
                if any_cb:
                    sw.write_cbf_chroma(1, ccb is not None)
                if any_cr:
                    sw.write_cbf_chroma(1, ccr is not None)
            cbf_l = ly[i] is not None
            sw.write_cbf_luma(False, cbf_l)
            sw.record_tu(px, py, log2_size - 1, cbf_l)
            if cbf_l:
                sw.write_residual(ly[i], log2_size - 1, 0, SCAN_DIAG,
                                  ts=lts[i], inter=True)
            if cat != 0:
                for ci, cc in ((1, ccb), (2, ccr)):
                    if cc is not None:
                        sw.write_residual(cc, clog2, ci, SCAN_DIAG)
            # closed-loop recon of this leaf
            res = transform_ref.scale_and_inv_transform(
                ly[i], self._qp_for(0), log2_size - 1, False, lts[i], False,
                cfg.bit_depth) if cbf_l else 0
            base = pred[0][py - y0:py - y0 + half, px - x0:px - x0 + half]
            self.recon[0][py:py + half, px:px + half] = \
                np.clip(base + res, 0, maxv).astype(dt)
            if cat != 0:
                cx, cy = px // sw_c, py // sh_c
                cw_, ch_ = half // sw_c, half // sh_c
                for ci, cc in ((1, ccb), (2, ccr)):
                    pc = pred[ci][cy - y0 // sh_c:cy - y0 // sh_c + ch_,
                                  cx - x0 // sw_c:cx - x0 // sw_c + cw_]
                    rc = transform_ref.scale_and_inv_transform(
                        cc, self._qp_for(ci), clog2, False, False, False,
                        cfg.bit_depth) if cc is not None else 0
                    self.recon[ci][cy:cy + ch_, cx:cx + cw_] = \
                        np.clip(pc + rc, 0, maxv).astype(dt)

    def _emit_gmv_cu(self, sw, x0, y0, log2_size, depth, idx):
        """True-motion CU: MV = cfg.global_mv exactly (mvd compensates the
        AMVP predictor); residual coded only where prediction misses.
        Produces realistically sparse streams (pan-shot class)."""
        from types import SimpleNamespace
        gmv = self.cfg.global_mv
        J = self.cfg.mv_jitter
        if J:
            hsh = x0 * 7 + y0 * 13 + self.frame.poc * 29
            gmv = (gmv[0] + hsh % (2 * J + 1) - J,
                   gmv[1] + (hsh // 31) % (2 * J + 1) - J)
        size = 1 << log2_size
        pred = self.motion._amvp_predictors(sw, x0, y0, size, size, 0, 0)[0]
        dec = SimpleNamespace(inter_dir=0, ref_idx=0,
                              mvd=(gmv[0] - pred[0], gmv[1] - pred[1]))
        self._emit_mv_cu(sw, x0, y0, log2_size, depth, idx,
                         with_residual=True, dec=dec)

    def _recon_inter_pu(self, pu, write=True):
        """MC with the decoder's exact ops; returns [Y,Cb,Cr] predictions."""
        sh = self.frame.slice_headers[0]
        pu.slice_header = sh
        preds = {}
        preds_c = {1: {}, 2: {}}
        for l in range(2):
            if not pu.pred_flag[l]:
                continue
            refpic = self.dpb.pics[pu.ref_dpb[l]]
            preds[l] = inter_ref.mc_luma(refpic.planes[0], pu.x, pu.y,
                                         pu.w, pu.h, pu.mv[l], self.cfg.bit_depth)
            sw_, sh2 = self.sps.SubWidthC, self.sps.SubHeightC
            if self.sps.ChromaArrayType != 0:
                for ci in (1, 2):
                    preds_c[ci][l] = inter_ref.mc_chroma(
                        refpic.planes[ci], pu.x // sw_, pu.y // sh2,
                        pu.w // sw_, pu.h // sh2, pu.mv[l],
                        self.cfg.bit_depth, subw=sw_, subh=sh2)
        bd = self.cfg.bit_depth
        out_y = inter_ref.weighted_combine(preds, pu, sh, 0, bd)
        if self.sps.ChromaArrayType != 0:
            out_c = [inter_ref.weighted_combine(preds_c[ci], pu, sh, ci, bd)
                     for ci in (1, 2)]
        else:
            z = np.zeros((0, 0), np.int32)
            out_c = [z, z]
        if write:
            dt = self.cfg.pix_dtype
            sw_, sh2 = self.sps.SubWidthC, self.sps.SubHeightC
            self.recon[0][pu.y:pu.y + pu.h, pu.x:pu.x + pu.w] = out_y.astype(dt)
            for k, ci in enumerate((1, 2)):
                self.recon[ci][pu.y // sh2:(pu.y + pu.h) // sh2,
                               pu.x // sw_:(pu.x + pu.w) // sw_] = out_c[k].astype(dt)
        return [out_y, out_c[0], out_c[1]]
