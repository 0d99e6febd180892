"""Copy of libde265_tpu/native_frontend.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package). Two
changes: slice pred-weight tables keep only the num_ref_idx_lX_active
entries of each list, not 16 entries of which the rest are uninitialised
memory from the C++ side; and a checkout without the library builds it
(_build.ensure_frontend) instead of refusing.

ctypes binding for the C++ front-end (native/libhevc_frontend.so).

Produces FramePlan objects identical to the pure-Python front-end (which is
its differential-test oracle) — NAL/header/CABAC/motion work runs natively,
pixel reconstruction stays in the JAX/numpy backend.
"""
import ctypes as C
import os

import numpy as np

from . import _build, telemetry
from .plan import FramePlan, TURecord, PURecord, MODE_INTRA, MODE_INTER

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        path = os.environ.get("HEVC_FRONTEND_SO") \
            or _build.ensure_frontend(_build.NATIVE)
        _LIB = C.CDLL(path)
        _LIB.fe_new.restype = C.c_void_p
        _LIB.fe_push_stream.argtypes = [C.c_void_p, C.c_char_p, C.c_int64]
        _LIB.fe_error.restype = C.c_char_p
        _LIB.fe_error.argtypes = [C.c_void_p]
    return _LIB


def _arr(a):
    return a.ctypes.data_as(C.c_void_p)


class NativeFrontend:
    """Parses a whole Annex-B stream natively; yields FramePlans."""

    def __init__(self):
        self.lib = _lib()
        self.h = self.lib.fe_new()

    def __del__(self):
        try:
            if getattr(self, "h", None) and self.lib is not None:
                self.lib.fe_free(C.c_void_p(self.h))
        except Exception:
            pass
        self.h = None

    def parse(self, stream: bytes, sps_map, pps_map):
        """sps_map/pps_map: python-parsed parameter sets (the native side has
        its own; python ones carry derived values for the backend).
        Spans: parse (n: frames), with parse.slices (the C++ parse) and
        parse.extract (the FramePlans) inside."""
        with telemetry.span("parse") as sp:
            with telemetry.span("parse.slices", len(stream)):
                n = self.lib.fe_push_stream(self.h, stream, len(stream))
            if n < 0:
                raise ValueError(
                    "native front-end error: "
                    + self.lib.fe_error(C.c_void_p(self.h)).decode())
            with telemetry.span("parse.extract", n):
                plans = self.extract_all(n, sps_map, pps_map)
            sp.n = n
            return plans

    def extract_all(self, n, sps_map, pps_map):
        """Materialize n parsed frames as FramePlans. The per-frame
        extraction is memcpy-bound inside ctypes calls (GIL released)
        and fe_get_* only read Frame state — a small pool overlaps the
        copies."""
        if n >= 8:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=4) as ex:
                return list(ex.map(
                    lambda i: self._frame(i, sps_map, pps_map), range(n)))
        return [self._frame(i, sps_map, pps_map) for i in range(n)]

    def _frame(self, idx, sps_map, pps_map):
        lib = self.lib
        info = np.zeros(23, np.int32)
        assert lib.fe_frame_info(C.c_void_p(self.h), idx, _arr(info)) == 0
        (W, H, poc, nal_type, output_flag, n_tus, n_pus, clen, plen, n_slices,
         gw, gh, nctbx, nctby, max_reorder, cl, cr, ct_, cb, sps_id, frame_id,
         mw, mh) = [int(v) for v in info]
        sps = sps_map[sps_id]
        pps = list(pps_map.values())[0]
        plan = FramePlan(sps, pps, poc=poc)
        plan.frame_id = frame_id
        plan.nal_type = nal_type
        plan.output_flag = output_flag
        plan.max_num_reorder = max_reorder
        assert plan.gw == gw and plan.gh == gh, (plan.gw, gw, plan.gh, gh)

        # np.empty: fe_get_grids memcpy-fills every element
        mv = np.empty((gh, gw, 2, 2), np.int16)
        ref_idx = np.empty((gh, gw, 2), np.int8)
        pred_flag = np.empty((gh, gw, 2), np.uint8)
        refpoc = np.empty((gh, gw, 2), np.int32)
        ref_lt = np.empty((gh, gw, 2), np.uint8)
        r = lib.fe_get_grids(
            C.c_void_p(self.h), idx,
            _arr(plan.pred_mode), _arr(plan.skip_flag), _arr(plan.intra_mode_y),
            _arr(plan.intra_mode_c), _arr(plan.ct_depth), _arr(plan.log2_cb_size),
            _arr(plan.qp_y), _arr(plan.tq_bypass), _arr(plan.pcm_flag),
            _arr(plan.cbf_luma), _arr(plan.tu_boundary), _arr(plan.pb_boundary),
            _arr(plan.cb_boundary), _arr(mv), _arr(ref_idx), _arr(pred_flag),
            _arr(refpoc), _arr(ref_lt))
        assert r == 0
        plan.mv = mv
        plan.ref_idx = ref_idx
        plan.pred_flag = pred_flag
        plan.ref_poc = refpoc
        plan.ref_lt = ref_lt

        slice_addr = np.empty((nctby, nctbx), np.int32)
        slice_seg = np.empty((nctby, nctbx), np.int32)
        sao_type = np.empty((nctby, nctbx, 3), np.uint8)
        sao_eo = np.empty((nctby, nctbx, 3), np.uint8)
        sao_band = np.empty((nctby, nctbx, 3), np.uint8)
        sao_off = np.empty((nctby, nctbx, 3, 4), np.int16)
        r = lib.fe_get_ctb_grids(C.c_void_p(self.h), idx, _arr(slice_addr),
                                 _arr(slice_seg), _arr(sao_type), _arr(sao_eo),
                                 _arr(sao_band), _arr(sao_off))
        assert r == 0
        plan.slice_addr_rs = slice_addr
        plan.ctb_slice_seg = slice_seg
        plan.sao.type_idx = sao_type
        plan.sao.eo_class = sao_eo
        plan.sao.band_pos = sao_band
        plan.sao.offsets = sao_off

        # empty when the native side fills every row; zeros for the
        # placeholder row of an empty list
        def buf(n, cols, dt=np.int32):
            shape = (n, cols) if cols else (n,)
            return np.empty(shape, dt) if n else np.zeros(
                (1, cols) if cols else (1,), dt)
        tu_meta = buf(n_tus, 12)
        coeffs = buf(clen, 0, np.int16)
        pcm = buf(plen, 0, np.int16)
        r = lib.fe_get_tus(C.c_void_p(self.h), idx, _arr(tu_meta), _arr(coeffs),
                           _arr(pcm))
        assert r == 0
        pu_meta = buf(n_pus, 17)
        r = lib.fe_get_pus(C.c_void_p(self.h), idx, _arr(pu_meta))
        assert r == 0
        sl = buf(n_slices, 16)
        r = lib.fe_get_slices(C.c_void_p(self.h), idx, _arr(sl))
        assert r == 0

        # slice headers (lightweight shims with the fields the backend uses)
        from .bitstream.sliceheader import SliceHeader, PredWeight
        for si in range(n_slices):
            (seg, addr_rs, typ, qp, boff, toff, nodbk, saol, saoc, lfa,
             mm, nr0, nr1, has_pw, cbq, crq) = [int(v) for v in sl[si]]
            s = SliceHeader()
            s.slice_segment_address = seg
            s.SliceAddrRS = addr_rs
            s.slice_type = typ
            s.SliceQPY = qp
            s.slice_beta_offset = boff
            s.slice_tc_offset = toff
            s.slice_deblocking_filter_disabled_flag = nodbk
            s.slice_sao_luma_flag = saol
            s.slice_sao_chroma_flag = saoc
            s.slice_loop_filter_across_slices_enabled_flag = lfa
            s.MaxNumMergeCand = mm
            s.num_ref_idx_l0_active = nr0
            s.num_ref_idx_l1_active = nr1
            s.slice_cb_qp_offset = cbq
            s.slice_cr_qp_offset = crq
            if has_pw:
                pwbuf = np.zeros(2 + 2 * 16 * 6, np.int32)
                lib.fe_get_pred_weights(C.c_void_p(self.h), idx, si, _arr(pwbuf))
                pw = PredWeight()
                pw.luma_log2_weight_denom = int(pwbuf[0])
                pw.chroma_log2_weight_denom = int(pwbuf[1])
                o = 2
                for l in range(2):
                    # entries past num_ref_idx_lX_active come back from the
                    # C++ side uninitialised: keep only the active ones
                    for rr in range(16):
                        if rr >= (nr0, nr1)[l]:
                            o += 6
                            continue
                        pw.luma_weight[l].append(int(pwbuf[o]))
                        pw.luma_offset[l].append(int(pwbuf[o + 1]))
                        pw.chroma_weight[l].append([int(pwbuf[o + 2]), int(pwbuf[o + 4])])
                        pw.chroma_offset[l].append([int(pwbuf[o + 3]), int(pwbuf[o + 5])])
                        o += 6
                s.pred_weight = pw
            else:
                s.pred_weight = None
            plan.slice_headers.append(s)

        # lazy record lists: raw arrays attached, materialized on access
        plan._tu_arrays = (tu_meta[:n_tus], coeffs, pcm)
        plan._pu_arrays = (pu_meta[:n_pus], plan.slice_headers)
        # intra wavefront levels from the C++ DP (intra_fused consumes;
        # falls back to the Python DP when the symbol is absent)
        if n_tus and hasattr(lib, "fe_intra_levels"):
            lv = np.zeros(n_tus, np.int32)
            if lib.fe_intra_levels(C.c_void_p(self.h), idx, _arr(lv)) == 0:
                plan._intra_levels = lv
        plan._fe = (self, idx)    # native pack (fe_pack_frame) handle
        return plan

    # ---------------------------------------------------- native packing
    # key-kind ids (must match PackKeyKind in native/frontend.cc)
    PACK_KINDS = {
        "pm": 0, "cbf": 1, "off": 2, "tucb": 3, "edgeall": 4, "qp": 5,
        "pf": 6, "mv": 7, "poc": 8, "slot": 9, "allow_v": 10,
        "allow_h": 11, "pair_ok": 12, "sao_type": 13, "sao_eo": 14,
        "sao_band": 15, "sao_off": 16, "sidx": 17, "sh_disable": 18,
        "sh_beta": 19, "sh_tc": 20, "sh_across": 21, "sh_sao_luma": 22,
        "sh_sao_chroma": 23,
    }
    PACK_BUCKET_KINDS = {
        "rc": 24, "rb": 25, "rbi": 26, "re_i": 27, "re_v": 28,
        "rk": 29, "rq": 30, "rs": 31,
    }
    PACK_DT_SLOTS = {"|i1": 0, "|u1": 1, "<i2": 2, "<i4": 3, "|b1": 4}

    def pack_setup(self, cfg, meta, nframes):
        """Configure fe_pack_frame for a blob layout (blob_meta tuple of
        the F-frame stacked batch). Returns False when any key is outside
        the native writer set — caller packs with numpy instead."""
        keys = []
        for (k, dt, shape, off) in meta:
            sz = (int(np.prod(shape)) if shape else 1) // nframes
            dslot = self.PACK_DT_SLOTS.get(dt)
            if dslot is None:
                return False
            parts = k.rsplit("_", 2)
            if k in self.PACK_KINDS:
                keys.append((self.PACK_KINDS[k], dslot, off, sz,
                             0, 0, 0, 0, 0, 0))
            elif len(parts) == 3 and parts[0] in self.PACK_BUCKET_KINDS:
                base, cidx_s, log2_s = parts
                cidx, log2 = int(cidx_s), int(log2_s)
                bi = [i for i, b in enumerate(cfg.buckets)
                      if b[0] == cidx and b[1] == log2]
                if not bi:
                    return False
                b = cfg.buckets[bi[0]]
                E = cfg.escapes[bi[0]] if cfg.escapes else 0
                Ssb = cfg.sb_caps[bi[0]] if cfg.sb_caps else 0
                kinds = cfg.res_kinds[bi[0]] if cfg.res_kinds else 0
                keys.append((self.PACK_BUCKET_KINDS[base], dslot, off,
                             sz, cidx, log2, b[2], E, Ssb, kinds))
            else:
                return False
        if cfg.has_weights or not cfg.pack_bits:
            return False
        karr = np.asarray(keys, np.int64)
        carr = np.asarray([
            cfg.W, cfg.H, cfg.log2ctb, cfg.n_slice_rows,
            int(cfg.pack_bits), int(cfg.qp_grid8), int(cfg.lane0),
            int(cfg.pu_grid8), int(cfg.mv8), int(cfg.poc8),
            int(cfg.pcm_lfd), int(cfg.skip_mc), cfg.r_act,
            cfg.subw, cfg.subh], np.int32)
        r = self.lib.fe_pack_setup(C.c_void_p(self.h), _arr(carr),
                                   len(carr), _arr(karr), len(keys))
        return r == 0

    def pack_frame_into(self, idx, batch_index, fid_slot, bufs):
        """Fill one frame's keys into the per-dtype blob buffers
        (pack_blob layout). fid_slot: {frame_id: dpb_slot}."""
        fids = np.asarray(list(fid_slot.keys()), np.int32)
        slots = np.asarray(list(fid_slot.values()), np.int32)
        ptrs = [None] * 5
        for dt, arr in bufs.items():
            ptrs[self.PACK_DT_SLOTS[dt]] = arr
        args = [_arr(p) if p is not None else None for p in ptrs]
        r = self.lib.fe_pack_frame(
            C.c_void_p(self.h), idx, batch_index, _arr(fids), _arr(slots),
            len(fids), *args)
        if r != 0:
            raise RuntimeError(f"fe_pack_frame failed: {r}")
