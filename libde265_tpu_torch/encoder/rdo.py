"""Copy of libde265_tpu/encoder/rdo.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Rate-distortion-optimized mode decision for the encoder.

Capability counterpart of the reference's EncoderCore + Algo_* module stack
(libde265/encoder/encoder-core.h:82-130, encoder/algo/
algo-cb-split.*, algo-tb-intrapredmode.*, ~2.8k LoC): CU quadtree split
search, intra-mode selection, and inter skip/merge/AMVP decision with an
integer+fractional-pel motion search, all driven by true RD cost
D + lambda*R where R comes from trial-emitting the exact CTU syntax
(encoder/syntax.py SliceWriter) into a CABAC bit estimator
(encoder/rate_estim.py, the counterpart of CABAC_encoder_estim
libde265/cabac.h:165-186) with context states threaded
along the search path.

Design (original, not a port of the reference's Algo class graph):
the quadtree is searched once per CTB at the first `want_split` query,
using trial emissions against snapshot/restore of the affected FramePlan
metadata region + recon pixels; the winning decision tree is cached and
the real CABAC write pass replays it.  Trials run through the SAME
SliceWriter with its `cabac`/`ctx` temporarily swapped to an estimator and
a cloned context table, so rate estimates see the exact syntax, context
derivations, and adaptation the real encode will produce.
"""
from dataclasses import dataclass
import numpy as np

from .rate_estim import CabacEstimator
from ..bitstream.sliceheader import SLICE_TYPE_I
from ..plan import MODE_INTRA

# per-4x4 metadata grids a CU emission can touch (plan.py FramePlan)
_GRIDS4 = (
    "pred_mode", "skip_flag", "intra_mode_y", "intra_mode_c", "ct_depth",
    "log2_cb_size", "qp_y", "tq_bypass", "pcm_flag", "cbf_luma",
    "tu_boundary", "pb_boundary", "cb_boundary", "mv", "ref_idx",
    "pred_flag", "ref_poc", "ref_lt",
)


def rd_lambda(qp, slice_type):
    """HM-style mode-decision lambda (alpha * 2^((QP-12)/3))."""
    alpha = 0.57 if slice_type == SLICE_TYPE_I else 0.85
    return alpha * 2.0 ** ((qp - 12) / 3.0)


class _RegionState:
    """Snapshot of everything a CU emission at (x0,y0,size n) can mutate:
    the per-4x4 grid subregions, recon pixel subregions, the PU list, and
    the search-path context table."""

    def __init__(self, enc, x0, y0, n, sctx):
        f = enc.frame
        W, H = f.sps.pic_width_in_luma_samples, f.sps.pic_height_in_luma_samples
        self.x0, self.y0 = x0, y0
        x1, y1 = min(x0 + n, W), min(y0 + n, H)
        self.g = (slice(y0 >> 2, (y1 + 3) >> 2), slice(x0 >> 2, (x1 + 3) >> 2))
        self.grids = {k: getattr(f, k)[self.g].copy() for k in _GRIDS4}
        self.rec = [
            enc.recon[0][y0:y1, x0:x1].copy(),
            enc.recon[1][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1].copy(),
            enc.recon[2][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1].copy(),
        ]
        self.bounds = (x0, y0, x1, y1)
        self.pus = list(f.pus)
        self.sctx = _clone_ctx(sctx)

    def restore(self, enc):
        f = enc.frame
        x0, y0, x1, y1 = self.bounds
        for k in _GRIDS4:
            getattr(f, k)[self.g] = self.grids[k]
        enc.recon[0][y0:y1, x0:x1] = self.rec[0]
        enc.recon[1][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1] = self.rec[1]
        enc.recon[2][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1] = self.rec[2]
        f.pus[:] = self.pus
        return _clone_ctx(self.sctx)


def _clone_ctx(ctx):
    from ..bitstream.contextmodel import ContextModelTable
    t = ContextModelTable.__new__(ContextModelTable)
    t.models = [m[:] for m in ctx.models]
    t.stat_coeff = list(getattr(ctx, "stat_coeff", [0, 0, 0, 0]))
    return t


@dataclass
class LeafDec:
    kind: str                 # "intra" | "skip" | "amvp"
    mode: int = 0             # intra luma mode
    merge_idx: int = 0
    inter_dir: int = 0        # 0=L0 (P); B uses L0-only AMVP in v1
    ref_idx: int = 0
    mvd: tuple = (0, 0)


class RDOEmitter:
    """Drop-in for the fixed `_CUEmitter`: same want_split/emit interface,
    but decisions come from an RD search (counterpart of
    EncoderCore_Custom::encode_ctb, encoder-core.h:132)."""

    def __init__(self, enc, slice_type):
        self.enc = enc
        self.slice_type = slice_type
        self.cu_count = 0          # interface parity with _CUEmitter
        cfg = enc.cfg
        assert not cfg.pcm and not cfg.tq_bypass and not cfg.cu_qp_delta, \
            "RDO v1 does not search PCM/tq-bypass/per-CU QP"
        self.lmbda = rd_lambda(enc.cur_qp, slice_type)
        self.lmbda_mv = self.lmbda ** 0.5
        self.max_leaf_log2 = min(enc.sps.Log2CtbSizeY, enc.sps.Log2MaxTrafoSize)
        self.search_range = getattr(cfg, "rdo_search_range", 8)
        self.decisions = {}        # (x0,y0,log2) -> "leaf" | "split"
        self.leaf_dec = {}         # (x0,y0,log2) -> LeafDec
        self.sw = None             # bound by the encoder per slice

    # -------------------------------------------------- emitter interface
    def want_split(self, x0, y0, log2_size, depth):
        enc = self.enc
        n = 1 << log2_size
        inside = (x0 + n <= enc.sps.pic_width_in_luma_samples and
                  y0 + n <= enc.sps.pic_height_in_luma_samples)
        if not inside:
            return True            # split is forced by the writer anyway
        key = (x0, y0, log2_size)
        if key not in self.decisions:
            self._search_root(x0, y0, log2_size, depth)
        return self.decisions[key] == "split"

    def emit(self, sw, x0, y0, log2_size, depth):
        dec = self.leaf_dec[(x0, y0, log2_size)]
        self.cu_count += 1
        self._emit_dec(sw, dec, x0, y0, log2_size, depth)

    def _emit_dec(self, sw, dec, x0, y0, log2_size, depth):
        enc = self.enc
        enc._cur_bypass = False
        if dec.kind == "intra":
            enc._emit_intra_cu(sw, x0, y0, log2_size, depth, 0, mode=dec.mode)
        elif dec.kind == "skip":
            enc._emit_skip_cu(sw, x0, y0, log2_size, depth, 0,
                              merge_idx=dec.merge_idx)
        else:
            enc._emit_mv_cu(sw, x0, y0, log2_size, depth, 0,
                            with_residual=True, dec=dec)

    # ------------------------------------------------------------ search
    def _search_root(self, x0, y0, log2_size, depth):
        sw = self.sw
        self._sctx = _clone_ctx(sw.ctx)
        root_snap = _RegionState(self.enc, x0, y0, 1 << log2_size, self._sctx)
        self._search(x0, y0, log2_size, depth)
        root_snap.restore(self.enc)   # real pass replays the decisions

    def _search(self, x0, y0, log2_size, depth):
        """Returns winner cost; leaves winner state applied and decisions
        cached; advances self._sctx past the winner's bins."""
        enc, sw = self.enc, self.sw
        n = 1 << log2_size
        key = (x0, y0, log2_size)
        can_leaf = log2_size <= self.max_leaf_log2
        can_split = log2_size > enc.sps.Log2MinCbSizeY
        # rate of split_cu_flag (context depends on neighbor depths, which
        # are final for out-of-region neighbors at this point)
        flag_bits = self._split_flag_bits(x0, y0, depth) if \
            (can_split and can_leaf) else 0.0

        snap0 = _RegionState(enc, x0, y0, n, self._sctx)
        cost_leaf = np.inf
        leaf_state = None
        if can_leaf:
            cost_leaf = self._eval_leaf(x0, y0, log2_size, depth)
            cost_leaf += self.lmbda * flag_bits
            if can_split:
                leaf_state = _RegionState(enc, x0, y0, n, self._sctx)
        if not can_split:
            self.decisions[key] = "leaf"
            return cost_leaf

        self._sctx = snap0.restore(enc)
        cost_split = self.lmbda * flag_bits
        half = n >> 1
        W = enc.sps.pic_width_in_luma_samples
        H = enc.sps.pic_height_in_luma_samples
        for (cx, cy) in ((x0, y0), (x0 + half, y0),
                         (x0, y0 + half), (x0 + half, y0 + half)):
            if cx >= W or cy >= H:
                continue
            if cx + half <= W and cy + half <= H:
                cost_split += self._search(cx, cy, log2_size - 1, depth + 1)
            else:   # partial child: forced further split, no leaf choice
                cost_split += self._search_forced(cx, cy, log2_size - 1,
                                                  depth + 1)
            if cost_split >= cost_leaf:
                break    # early-out: split already worse

        if cost_leaf <= cost_split:
            self._sctx = leaf_state.restore(enc)
            # re-apply leaf winner state (restore() returns pre-trial sctx;
            # leaf_state was captured post-winner so grids/recon are final)
            self.decisions[key] = "leaf"
            # drop any child decisions cached by the losing split trial
            self._drop_children(x0, y0, log2_size)
            return cost_leaf
        self.decisions[key] = "split"
        return cost_split

    def _search_forced(self, x0, y0, log2_size, depth):
        """Node partially outside the picture: split is forced (no flag)."""
        enc = self.enc
        key = (x0, y0, log2_size)
        if log2_size <= enc.sps.Log2MinCbSizeY:
            # fully-outside leaves are never emitted; inside ones searched
            return self._search(x0, y0, log2_size, depth)
        self.decisions[key] = "split"
        half = 1 << (log2_size - 1)
        W = enc.sps.pic_width_in_luma_samples
        H = enc.sps.pic_height_in_luma_samples
        cost = 0.0
        for (cx, cy) in ((x0, y0), (x0 + half, y0),
                         (x0, y0 + half), (x0 + half, y0 + half)):
            if cx >= W or cy >= H:
                continue
            if cx + half <= W and cy + half <= H:
                cost += self._search(cx, cy, log2_size - 1, depth + 1)
            else:
                cost += self._search_forced(cx, cy, log2_size - 1, depth + 1)
        return cost

    def _drop_children(self, x0, y0, log2_size):
        half = 1 << (log2_size - 1)
        for (cx, cy) in ((x0, y0), (x0 + half, y0),
                         (x0, y0 + half), (x0 + half, y0 + half)):
            k = (cx, cy, log2_size - 1)
            if k in self.decisions:
                if self.decisions.pop(k) == "split":
                    self._drop_children(cx, cy, log2_size - 1)
                self.leaf_dec.pop(k, None)

    def _split_flag_bits(self, x0, y0, depth):
        sw, f = self.sw, self.enc.frame
        ctx_inc = 0
        if sw.available_zscan(x0, y0, x0 - 1, y0) and \
                f.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
            ctx_inc += 1
        if sw.available_zscan(x0, y0, x0, y0 - 1) and \
                f.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
            ctx_inc += 1
        state, _ = self._sctx.at("split_cu_flag", ctx_inc)
        from .rate_estim import ENTROPY_TABLE
        # average of MPS/LPS bits — the flag differs between the two
        # branches being compared, so charge both the same expectation
        return (ENTROPY_TABLE[state][0] + ENTROPY_TABLE[state][1]) / 2 / 0x8000

    # ---------------------------------------------------------- leaf eval
    def _eval_leaf(self, x0, y0, log2_size, depth):
        """Try all leaf candidates; apply the winner (state + sctx advance),
        cache its LeafDec, and return its cost."""
        cands = self._leaf_candidates(x0, y0, log2_size, depth)
        best = (np.inf, None, None)
        enc = self.enc
        n = 1 << log2_size
        pre = _RegionState(enc, x0, y0, n, self._sctx)
        for dec in cands:
            cost = self._trial(dec, x0, y0, log2_size, depth)
            if cost < best[0]:
                best = (cost, dec, None)
            self._sctx = pre.restore(enc)
        cost, dec, _ = best
        # apply winner for real (advances self._sctx, leaves state written)
        self._apply_trial(dec, x0, y0, log2_size, depth)
        self.leaf_dec[(x0, y0, log2_size)] = dec
        return cost

    def _trial(self, dec, x0, y0, log2_size, depth):
        bits = self._apply_trial(dec, x0, y0, log2_size, depth)
        d = self._ssd(x0, y0, 1 << log2_size)
        return d + self.lmbda * bits

    def _apply_trial(self, dec, x0, y0, log2_size, depth):
        """Emit `dec` through the slice writer with an estimator CABAC and
        the search context table; returns estimated bits."""
        sw = self.sw
        est = CabacEstimator()
        save_cab, save_ctx = sw.cabac, sw.ctx
        sw.cabac, sw.ctx = est, self._sctx
        try:
            self._emit_dec(sw, dec, x0, y0, log2_size, depth)
        finally:
            sw.cabac, sw.ctx = save_cab, save_ctx
        return est.bits

    def _ssd(self, x0, y0, n):
        enc = self.enc
        W = enc.sps.pic_width_in_luma_samples
        H = enc.sps.pic_height_in_luma_samples
        x1, y1 = min(x0 + n, W), min(y0 + n, H)
        d = 0.0
        a = enc.src[0][y0:y1, x0:x1].astype(np.int64)
        b = enc.recon[0][y0:y1, x0:x1].astype(np.int64)
        d += float(((a - b) ** 2).sum())
        for ci in (1, 2):
            a = enc.src[ci][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1] \
                .astype(np.int64)
            b = enc.recon[ci][y0 >> 1:(y1 + 1) >> 1, x0 >> 1:(x1 + 1) >> 1] \
                .astype(np.int64)
            d += float(((a - b) ** 2).sum())
        return d

    # ------------------------------------------------------ candidate sets
    def _leaf_candidates(self, x0, y0, log2_size, depth):
        enc = self.enc
        if self.slice_type == SLICE_TYPE_I:
            return [LeafDec("intra", mode=m)
                    for m in self._intra_modes(x0, y0, log2_size)]
        cands = []
        n_merge = self.sw.sh.MaxNumMergeCand
        for m in range(n_merge):
            cands.append(LeafDec("skip", merge_idx=m))
        amvp = self._motion_search(x0, y0, log2_size)
        if amvp is not None:
            cands.append(amvp)
        for m in self._intra_modes(x0, y0, log2_size, inter_slice=True):
            cands.append(LeafDec("intra", mode=m))
        return cands

    def _intra_modes(self, x0, y0, log2_size, inter_slice=False):
        """SAD-preselected candidate modes + MPMs (counterpart of
        Algo_TB_IntraPredMode_FastBrute, algo-tb-intrapredmode.cc)."""
        from ..ops import intra_ref
        from ..reconstruct import gather_border
        enc = self.enc
        n = 1 << log2_size
        bd = enc.cfg.bit_depth
        src = enc.src[0][y0:y0 + n, x0:x0 + n].astype(np.int32)
        ref = gather_border(enc.frame, enc.recon, enc.avail, x0, y0,
                            log2_size, 0, bd)
        coarse = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)
        sads = []
        for m in coarse:
            fr = intra_ref.filter_border(ref, n, m, 0, bd,
                                         bool(enc.cfg.strong_intra_smoothing))
            pred = intra_ref.predict(fr, m, log2_size, 0, bd)
            sads.append((float(np.abs(src - pred).sum()), m))
        sads.sort()
        keep = 2 if inter_slice else 3
        modes = [m for _, m in sads[:keep]]
        for m in self.sw.derive_mpm(x0, y0):
            if m not in modes:
                modes.append(m)
        # refine around the best angular candidate
        best = modes[0]
        if best >= 2 and not inter_slice:
            for m in (best - 1, best + 1):
                if 2 <= m <= 34 and m not in modes:
                    modes.append(m)
        return modes

    # ------------------------------------------------------- motion search
    def _motion_search(self, x0, y0, log2_size):
        """Integer-pel diamond + qpel refinement around the AMVP predictor
        (counterpart of Algo_PB_MV_Search, algo-pb-mv.cc). L0, mvp_flag 0."""
        from ..ops import inter_ref
        enc, sw = self.enc, self.sw
        n = 1 << log2_size
        n_act = sw.sh.num_ref_idx_l0_active
        src = enc.src[0][y0:y0 + n, x0:x0 + n].astype(np.int32)
        best = None   # (cost, ref_idx, mv)
        for ref_idx in range(min(n_act, 2)):
            try:
                pred = enc.motion._amvp_predictors(sw, x0, y0, n, n, 0,
                                                   ref_idx)[0]
            except Exception:
                continue
            refpic = enc.dpb.pics[enc.motion.ref_dpb[0][ref_idx]]
            plane = refpic.planes[0].astype(np.int32)
            H, W = plane.shape

            def sad_int(ix, iy):
                xs, ys = x0 + ix, y0 + iy
                xs = max(0, min(xs, W - n))
                ys = max(0, min(ys, H - n))
                blk = plane[ys:ys + n, xs:xs + n]
                return float(np.abs(src - blk).sum())

            cx, cy = pred[0] >> 2, pred[1] >> 2
            r = self.search_range
            cx = max(-r, min(r, cx))
            cy = max(-r, min(r, cy))
            bcost, bx, by = None, cx, cy
            # coarse diamond descent
            step = max(1, r // 2)
            while True:
                improved = False
                for dx, dy in ((0, 0), (step, 0), (-step, 0), (0, step),
                               (0, -step), (step, step), (-step, -step),
                               (step, -step), (-step, step)):
                    tx, ty = bx + dx, by + dy
                    if abs(tx) > r or abs(ty) > r:
                        continue
                    mvb = self._mv_bits((tx << 2) - pred[0],
                                        (ty << 2) - pred[1])
                    c = sad_int(tx, ty) + self.lmbda_mv * mvb
                    if bcost is None or c < bcost:
                        bcost, bx, by = c, tx, ty
                        improved = True
                if not improved:
                    if step == 1:
                        break
                    step //= 2
            # quarter-pel refinement (exact MC taps)
            bmv = (bx << 2, by << 2)
            for _ in range(2):
                cur = bmv
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1),
                               (2, 0), (-2, 0), (0, 2), (0, -2)):
                    mv = (cur[0] + dx, cur[1] + dy)
                    p = inter_ref.mc_luma(refpic.planes[0], x0, y0, n, n, mv,
                                          enc.cfg.bit_depth)
                    mvb = self._mv_bits(mv[0] - pred[0], mv[1] - pred[1])
                    c = float(np.abs(src - p).sum()) + self.lmbda_mv * mvb
                    if c < bcost:
                        bcost, bmv = c, mv
                if bmv == cur:
                    break
            mvd = (bmv[0] - pred[0], bmv[1] - pred[1])
            if best is None or bcost < best[0]:
                best = (bcost, ref_idx, mvd)
        if best is None:
            return None
        return LeafDec("amvp", inter_dir=0, ref_idx=best[1], mvd=best[2])

    @staticmethod
    def _mv_bits(dx, dy):
        b = 0.0
        for d in (dx, dy):
            a = abs(d)
            b += 1 if a == 0 else (3 + 2 * max(0, a - 1).bit_length())
        return b
