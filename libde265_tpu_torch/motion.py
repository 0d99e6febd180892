"""Copy of libde265_tpu/motion.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Motion vector derivation: merge candidates, AMVP, temporal MV prediction
(spec 8.5.3.1/8.5.3.2) and PU record emission.

Capability counterpart of libde265/motion.cc
(derive_spatial_merging_candidates, derive_collocated_motion_vectors,
derive_combined_bipredictive_merging_candidates, fill_luma_motion_vector_
predictors, motion_vectors_and_ref_indices, decode_prediction_unit).
Runs in the serial front-end; produces fully-resolved PURecords that the
TPU backend consumes as a flat batch.
"""
import numpy as np

from .plan import PURecord, MODE_INTER, MODE_INTRA, \
    PART_Nx2N, PART_nLx2N, PART_nRx2N, PART_2NxN, PART_2NxnU, PART_2NxnD
from .bitstream.sliceheader import SLICE_TYPE_B

PRED_L0, PRED_L1, PRED_BI = 0, 1, 2


def clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def mv_wrap(v):
    """MVs live in 16-bit two's complement (motion.cc mv wrap semantics)."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def scale_mv(mv, tb, td):
    """spec 8.5.3.2.9 POC-distance MV scaling."""
    td = clip3(-128, 127, td)
    tb = clip3(-128, 127, tb)
    tx = (16384 + (abs(td) >> 1)) // td if td != 0 else 0
    dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6)
    def s(c):
        v = dsf * c
        return clip3(-32768, 32767, (abs(v) + 127 >> 8) * (1 if v >= 0 else -1))
    return (s(mv[0]), s(mv[1]))


class Cand:
    __slots__ = ("pf", "mv", "ref")

    def __init__(self, pf=(0, 0), mv=((0, 0), (0, 0)), ref=(-1, -1)):
        self.pf = tuple(pf)
        self.mv = tuple(tuple(m) for m in mv)
        self.ref = tuple(ref)

    def same_motion(self, o):
        return self.pf == o.pf and self.mv == o.mv and self.ref == o.ref


class MotionDeriver:
    def __init__(self, decoder, frame, sh):
        self.dec = decoder
        self.frame = frame
        self.sh = sh
        self.dpb = decoder.dpb
        self.poc = frame.poc
        # per-list POC / long-term of active refs
        self.ref_poc = sh.RefPOC if sh.RefPicList else [[], []]
        self.ref_lt = sh.RefIsLongTerm if sh.RefPicList else [[], []]
        self.ref_dpb = sh.RefPicList or [[], []]
        # collocated picture for TMVP
        self.col = None
        if sh.slice_temporal_mvp_enabled_flag and sh.RefPicList:
            lidx = 0 if sh.collocated_from_l0_flag else 1
            if sh.collocated_ref_idx < len(self.ref_dpb[lidx]):
                self.col = self.dpb.pics[self.ref_dpb[lidx][sh.collocated_ref_idx]]

    # -------------------------------------------------------------- helpers
    def _avail_pred(self, x, y, nx, ny, reader):
        """Neighbour PB availability (spec 6.4.2): z-scan + not intra."""
        if not reader.available_zscan(x, y, nx, ny):
            return False
        if self.frame.pred_mode[ny >> 2, nx >> 2] != MODE_INTER:
            return False
        return True

    def _nb_cand(self, nx, ny):
        f = self.frame
        gy, gx = ny >> 2, nx >> 2
        return Cand(pf=tuple(f.pred_flag[gy, gx]),
                    mv=((int(f.mv[gy, gx, 0, 0]), int(f.mv[gy, gx, 0, 1])),
                        (int(f.mv[gy, gx, 1, 0]), int(f.mv[gy, gx, 1, 1]))),
                    ref=tuple(int(r) for r in f.ref_idx[gy, gx]))

    # --------------------------------------------------------------- merge
    def decode_merge(self, reader, xC, yC, x0, y0, w, h, part_idx, part_mode,
                     ct_depth, merge_idx):
        sh = self.sh
        plevel = self.frame.pps.log2_parallel_merge_level
        log2_cb = int(self.frame.log2_cb_size[yC >> 2, xC >> 2])
        # singleMCLFlag: 8x8 CB with parallel_merge_level > 2 derives a single
        # merge list at the CB (spec 8.5.3.2.1)
        single_mcl = (plevel > 2 and log2_cb == 3)
        if single_mcl:
            mx, my, mw, mh, mpart, midx = xC, yC, 8, 8, 0, 0
        else:
            mx, my, mw, mh, mpart, midx = x0, y0, w, h, part_mode, part_idx
        cands = self._merge_candidates(reader, mx, my, mw, mh, mpart, midx, plevel)
        cand = cands[min(merge_idx, len(cands) - 1)]
        pf = list(cand.pf)
        mv = [list(cand.mv[0]), list(cand.mv[1])]
        ref = list(cand.ref)
        if w + h == 12 and pf[0] and pf[1]:
            pf[1] = 0  # small-PU bi-pred restriction (8.5.3.2.1)
            ref[1] = -1
        self._store_pu(x0, y0, w, h, pf, mv, ref)

    def _merge_candidates(self, reader, x0, y0, w, h, part_mode, part_idx, plevel):
        sh = self.sh
        out = []

        def plevel_same(nx, ny):
            return (x0 >> plevel) == (nx >> plevel) and (y0 >> plevel) == (ny >> plevel)

        def get(nx, ny, blocked):
            if blocked or plevel_same(nx, ny):
                return None
            if not self._avail_pred(x0, y0, nx, ny, reader):
                return None
            return self._nb_cand(nx, ny)

        # A1
        a1_blocked = part_idx == 1 and part_mode in (PART_Nx2N, PART_nLx2N, PART_nRx2N)
        a1 = get(x0 - 1, y0 + h - 1, a1_blocked)
        if a1 is not None:
            out.append(a1)
        # B1
        b1_blocked = part_idx == 1 and part_mode in (PART_2NxN, PART_2NxnU, PART_2NxnD)
        b1 = get(x0 + w - 1, y0 - 1, b1_blocked)
        if b1 is not None and not (a1 is not None and b1.same_motion(a1)):
            out.append(b1)
        else:
            b1 = None if b1 is None else b1  # keep for B0 pruning even if dropped
        b1_for_prune = get(x0 + w - 1, y0 - 1, b1_blocked)
        # B0
        b0 = get(x0 + w, y0 - 1, False)
        if b0 is not None and not (b1_for_prune is not None and b0.same_motion(b1_for_prune)):
            out.append(b0)
        # A0
        a0 = get(x0 - 1, y0 + h, False)
        if a0 is not None and not (a1 is not None and a0.same_motion(a1)):
            out.append(a0)
        # B2 (only if < 4 so far)
        if len(out) < 4:
            b2 = get(x0 - 1, y0 - 1, False)
            if b2 is not None and \
                    not (a1 is not None and b2.same_motion(a1)) and \
                    not (b1_for_prune is not None and b2.same_motion(b1_for_prune)):
                out.append(b2)
        # temporal
        if sh.slice_temporal_mvp_enabled_flag and len(out) < sh.MaxNumMergeCand:
            tc = self._temporal_merge(x0, y0, w, h)
            if tc is not None:
                out.append(tc)
        # combined bi-predictive (B slices)
        if sh.slice_type == SLICE_TYPE_B:
            out = self._combined_bipred(out)
        # zero candidates
        n_ref = min(sh.num_ref_idx_l0_active,
                    sh.num_ref_idx_l1_active) if sh.slice_type == SLICE_TYPE_B \
            else sh.num_ref_idx_l0_active
        zero_idx = 0
        while len(out) < sh.MaxNumMergeCand:
            r = zero_idx if zero_idx < n_ref else 0
            if sh.slice_type == SLICE_TYPE_B:
                out.append(Cand(pf=(1, 1), mv=((0, 0), (0, 0)), ref=(r, r)))
            else:
                out.append(Cand(pf=(1, 0), mv=((0, 0), (0, 0)), ref=(r, -1)))
            zero_idx += 1
        return out[:sh.MaxNumMergeCand]

    def _combined_bipred(self, orig):
        sh = self.sh
        n = len(orig)
        if n < 2 or len(orig) >= sh.MaxNumMergeCand:
            return orig
        L0_IDX = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
        L1_IDX = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
        out = list(orig)
        for k in range(n * (n - 1)):
            i0, i1 = L0_IDX[k], L1_IDX[k]
            if i0 >= n or i1 >= n:
                continue
            c0, c1 = orig[i0], orig[i1]
            if not (c0.pf[0] and c1.pf[1]):
                continue
            poc0 = self.ref_poc[0][c0.ref[0]]
            poc1 = self.ref_poc[1][c1.ref[1]]
            if poc0 != poc1 or c0.mv[0] != c1.mv[1]:
                out.append(Cand(pf=(1, 1), mv=(c0.mv[0], c1.mv[1]),
                                ref=(c0.ref[0], c1.ref[1])))
                if len(out) >= sh.MaxNumMergeCand:
                    break
        return out

    # ------------------------------------------------------------ temporal
    def _temporal_merge(self, x0, y0, w, h):
        """Temporal merge candidate with refIdx 0 (both lists)."""
        pf = [0, 0]
        mv = [(0, 0), (0, 0)]
        nlists = 2 if self.sh.slice_type == SLICE_TYPE_B else 1
        for X in range(nlists):
            r = self._temporal_mv(x0, y0, w, h, X, 0)
            if r is not None:
                pf[X] = 1
                mv[X] = r
        if not (pf[0] or pf[1]):
            return None
        return Cand(pf=tuple(pf),
                    mv=(mv[0], mv[1]),
                    ref=(0 if pf[0] else -1, 0 if pf[1] else -1))

    def _temporal_mv(self, x0, y0, w, h, X, ref_idx):
        """spec 8.5.3.2.8: collocated MV for list X against refIdx."""
        col = self.col
        if col is None or col.plan is None:
            return None
        sps = self.frame.sps
        # bottom-right candidate C0
        xbr, ybr = x0 + w, y0 + h
        mvcol = None
        if (y0 >> sps.Log2CtbSizeY) == (ybr >> sps.Log2CtbSizeY) and \
                ybr < self.frame.H and xbr < self.frame.W:
            mvcol = self._col_mv(xbr, ybr, X, ref_idx)
        if mvcol is None:
            xc, yc = x0 + (w >> 1), y0 + (h >> 1)
            mvcol = self._col_mv(xc, yc, X, ref_idx)
        return mvcol

    def _col_mv(self, xc, yc, X, ref_idx):
        """spec 8.5.3.2.9 derivation of collocated motion vectors."""
        col = self.col
        plan = col.plan
        cx, cy = (xc >> 4), (yc >> 4)
        if cy >= plan.cintra.shape[0] or cx >= plan.cintra.shape[1]:
            return None
        if plan.cintra[cy, cx]:
            return None
        pf = plan.cpred_flag[cy, cx]
        if not (pf[0] or pf[1]):
            return None
        # pick the collocated list
        if not pf[0]:
            l = 1
        elif not pf[1]:
            l = 0
        else:
            # both: depends on whether all refs precede current picture
            all_before = True
            for ll in range(2):
                for p in self.ref_poc[ll]:
                    if p > self.poc:
                        all_before = False
            if all_before:
                l = X
            else:
                l = 0 if self.sh.collocated_from_l0_flag else 1
        mv = (int(plan.cmv[cy, cx, l, 0]), int(plan.cmv[cy, cx, l, 1]))
        col_ref_poc = int(plan.cref_poc[cy, cx, l])
        col_ref_lt = bool(plan.cis_long_term[cy, cx, l])
        targ_lt = bool(self.ref_lt[X][ref_idx])
        if col_ref_lt != targ_lt:
            return None
        if targ_lt:
            return mv
        col_diff = col.poc - col_ref_poc
        cur_diff = self.poc - self.ref_poc[X][ref_idx]
        if col_diff == cur_diff:
            return mv
        return scale_mv(mv, cur_diff, col_diff)

    # ---------------------------------------------------------------- AMVP
    def decode_amvp(self, reader, xC, yC, x0, y0, w, h, part_idx, part_mode,
                    ct_depth, inter_pred_idc, ref_idx, mvd, mvp_flag):
        pf = [0, 0]
        mv = [[0, 0], [0, 0]]
        ref = [-1, -1]
        ncbs = 1 << int(self.frame.log2_cb_size[yC >> 2, xC >> 2])
        cu = (xC, yC, ncbs, w, h, part_idx)
        for X in range(2):
            if (X == 0 and inter_pred_idc == PRED_L1) or \
               (X == 1 and inter_pred_idc == PRED_L0):
                continue
            pf[X] = 1
            ref[X] = ref_idx[X]
            pred = self._amvp_predictors(reader, x0, y0, w, h, X, ref_idx[X],
                                         cu)
            p = pred[mvp_flag[X]]
            mv[X][0] = mv_wrap(p[0] + mvd[X][0])
            mv[X][1] = mv_wrap(p[1] + mvd[X][1])
        self._store_pu(x0, y0, w, h, pf, mv, ref)

    def _amvp_predictors(self, reader, x0, y0, w, h, X, ref_idx, cu=None):
        """spec 8.5.3.2.6/8.5.3.2.7. Returns two (mvx,mvy) predictors.
        cu = (xC, yC, nCbS, nPbW, nPbH, part_idx): neighbours inside the
        SAME coding block are available by PU decode order, not z-scan
        (6.4.2 / image.cc:782-806 available_pred_blk) — only the NxN
        partIdx-1-reads-partIdx-2 corner is excluded."""
        f = self.frame
        Y = 1 - X
        targ_poc = self.ref_poc[X][ref_idx]
        targ_lt = bool(self.ref_lt[X][ref_idx])

        def nb(nx, ny):
            if cu is not None:
                xC, yC, ncbs, npw, nph, pidx = cu
                if xC <= nx < xC + ncbs and yC <= ny < yC + ncbs:
                    if (npw * 2 == ncbs and nph * 2 == ncbs and pidx == 1
                            and ny >= yC + nph and nx < xC + npw):
                        return None            # NxN partIdx 2 region
                    if self.frame.pred_mode[ny >> 2, nx >> 2] != MODE_INTER:
                        return None
                    return (nx >> 2, ny >> 2)
            if not self._avail_pred(x0, y0, nx, ny, reader):
                return None
            return (nx >> 2, ny >> 2)

        def try_direct(g):
            """pass 1: same reference picture, either list, no scaling."""
            gx, gy = g
            for l, rlist in ((X, X), (Y, Y)):
                if f.pred_flag[gy, gx, l]:
                    r = int(f.ref_idx[gy, gx, l])
                    if 0 <= r < len(self.ref_poc[l]):
                        if self.ref_poc[l][r] == targ_poc and \
                                bool(self.ref_lt[l][r]) == targ_lt:
                            return (int(f.mv[gy, gx, l, 0]), int(f.mv[gy, gx, l, 1]))
            return None

        def try_scaled(g):
            """pass 2: any reference, scale short-term by POC distance."""
            gx, gy = g
            for l in (X, Y):
                if f.pred_flag[gy, gx, l]:
                    r = int(f.ref_idx[gy, gx, l])
                    if not (0 <= r < len(self.ref_poc[l])):
                        continue
                    nb_lt = bool(self.ref_lt[l][r])
                    if nb_lt != targ_lt:
                        continue
                    mv = (int(f.mv[gy, gx, l, 0]), int(f.mv[gy, gx, l, 1]))
                    if targ_lt:
                        return mv
                    tb = self.poc - targ_poc
                    td = self.poc - self.ref_poc[l][r]
                    if tb == td:
                        return mv
                    return scale_mv(mv, tb, td)
            return None

        a0 = nb(x0 - 1, y0 + h)
        a1 = nb(x0 - 1, y0 + h - 1)
        is_scaled = a0 is not None or a1 is not None
        mvA = None
        for g in (a0, a1):
            if g is not None:
                mvA = try_direct(g)
                if mvA is not None:
                    break
        if mvA is None:
            for g in (a0, a1):
                if g is not None:
                    mvA = try_scaled(g)
                    if mvA is not None:
                        break
        b0 = nb(x0 + w, y0 - 1)
        b1 = nb(x0 + w - 1, y0 - 1)
        b2 = nb(x0 - 1, y0 - 1)
        mvB = None
        for g in (b0, b1, b2):
            if g is not None:
                mvB = try_direct(g)
                if mvB is not None:
                    break
        if not is_scaled:
            # A takes B's value; B re-derived with scaling (spec 8.5.3.2.7)
            if mvA is None:
                mvA = mvB
                mvB = None
            if mvB is None:
                pass
            mvB = None
            for g in (b0, b1, b2):
                if g is not None:
                    mvB = try_scaled(g)
                    if mvB is not None:
                        break
        cands = []
        if mvA is not None:
            cands.append(mvA)
        if mvB is not None and (mvA is None or mvB != mvA):
            cands.append(mvB)
        if len(cands) < 2 and self.sh.slice_temporal_mvp_enabled_flag:
            t = self._temporal_mv(x0, y0, w, h, X, ref_idx)
            if t is not None:
                cands.append(t)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[:2]

    # --------------------------------------------------------------- store
    def _store_pu(self, x0, y0, w, h, pf, mv, ref):
        f = self.frame
        gx, gy = x0 >> 2, y0 >> 2
        gw, gh = w >> 2, h >> 2
        ref_poc = [0, 0]
        ref_dpb = [-1, -1]
        ref_lt = [0, 0]
        for l in range(2):
            if pf[l]:
                ref_poc[l] = self.ref_poc[l][ref[l]]
                ref_dpb[l] = self.ref_dpb[l][ref[l]]
                ref_lt[l] = 1 if self.ref_lt[l][ref[l]] else 0
        f.pred_flag[gy:gy + gh, gx:gx + gw] = pf
        f.ref_idx[gy:gy + gh, gx:gx + gw] = ref
        for l in range(2):
            f.mv[gy:gy + gh, gx:gx + gw, l, 0] = mv[l][0]
            f.mv[gy:gy + gh, gx:gx + gw, l, 1] = mv[l][1]
            f.ref_poc[gy:gy + gh, gx:gx + gw, l] = ref_poc[l]
            f.ref_lt[gy:gy + gh, gx:gx + gw, l] = ref_lt[l]
        f.pb_boundary[gy:gy + gh, gx] |= 1
        f.pb_boundary[gy, gx:gx + gw] |= 2
        f.pus.append(PURecord(
            x=x0, y=y0, w=w, h=h, pred_flag=tuple(pf),
            mv=(tuple(mv[0]), tuple(mv[1])), ref_idx=tuple(ref),
            ref_poc=tuple(ref_poc), ref_dpb=tuple(ref_dpb)))
        self.frame.pus[-1].slice_header = self.sh
