"""The push decoders of the port: the surface of libde265_tpu.decoder.Decoder
(push_data / push_nal / flush / decode / reset / get_warning /
get_next_picture, the temporal-layer controls, SEI picture-hash checks,
typed warnings), decoding on a device. api.new_decoder(parse=...) picks
the front end.

parse="python", PictureDecoder: the JAX Decoder's own path
(libde265_tpu/decoder.py:237-621). One NAL per decode(); every slice is
parsed in Python (bitstream/ctu.py's SliceReader, motion.py's
MotionDeriver); POC (8.3.1), RPS marking (8.3.2) with grey stand-ins for
missing references, and the reference lists (8.3.4) run here on the
Python DPB (dpb.py), which bumps pictures out by the operating temporal
layer's max_num_reorder_pics, one picture per decode() as there. When a
picture ends, it is reconstructed on the device
(device_stream.PictureStreamDecoder: the frame program, the hybrid path,
or the numpy reference for frame_uses_rext_tools). The recovery is the
JAX decoder's: a corrupted slice keeps its decoded part
(SLICE_DATA_CORRUPTED); a frame whose host work refuses its plan
(bridge_plan, PictureStreamDecoder.prepare: before anything reaches the
device) is reconstructed by numpy (stats n_host_frames), and one that
numpy refuses too is concealed grey with SLICE_DATA_CORRUPTED; a full
DPB sets IMAGE_BUFFER_FULL, bumps output and drops the oldest reference
(DPB_FULL_PICTURE_DROPPED). Whatever the launch raises (a kernel's
wrapper refusing its inputs, the CUDA runtime) propagates out of
decode().

parse="native", Decoder (the default): the NAL-level work in Python
(parameter sets, SEI hashes, RASL skipping, temporal-layer gating,
slice-header checks) and the slices handed to the C++ front end a segment
at a time: a segment runs from one IDR or BLA picture to the next (never
cut at a CRA: its RASL pictures reference pictures before it). When a
segment ends (at the next IDR / BLA, or at the end of the stream after
flush), the front end parses the parameter sets and the segment's NALs as
one stream, and a DeviceStreamDecoder on the decoder's device
reconstructs it: frames route to the frame program, the hybrid device
path or numpy exactly as api.decode_stream_native routes them. A segment
that the front end refuses, or one of whose frames the host work refuses
before that frame's launches (device_stream.HostDataError), is decoded
again from the same NALs through the per-picture path
(stats n_python_segments), so its pictures and warnings are the JAX
decoder's. Documented difference: pictures come out a segment at a time,
not one NAL at a time. Their order and contents, their pts, the hash
checks and the warnings are the JAX decoder's; only the decode() call
after which a picture appears may differ (the warnings of a segment's
hash checks come when it is decoded).
"""
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import telemetry
from .bitstream import nal as nal_mod
from .bitstream.ctu import SliceReader
from .bitstream.nal import NALParser
from .bitstream.paramsets import PPS, SPS, VPS, read_pps, read_sps, read_vps
from .bitstream.sei import parse_sei, verify_picture_hash
from .bitstream.sliceheader import SLICE_TYPE_I, read_slice_header
from .device import resolve
from .device_stream import (DATA_ERRORS, HostDataError,
                            PictureStreamDecoder, bridge_plan,
                            stream_geometry)
from .dpb import DPB, LONG_TERM, SHORT_TERM, UNUSED
from .errors import DecodeError, Warning as W, WarningQueue
from .motion import MotionDeriver
from .packing import frame_uses_rext_tools
from .plan import FramePlan, grey_planes
from .reconstruct import reconstruct_frame

_START = b"\x00\x00\x00\x01"


def escape(nal):
    """The NAL's bytes as they stood in the stream: the payload with the
    emulation-prevention bytes put back where unescape_rbsp took them
    out."""
    if not nal.skipped:
        return nal.data
    out = bytearray()
    prev = 0
    for pos in nal.skipped:
        out += nal.data[prev:pos]
        out.append(3)
        prev = pos
    out += nal.data[prev:]
    return bytes(out)


class _NalDecoder:
    """What both push decoders share: the API around the NAL parser,
    the warning queue, the temporal-layer controls and the routing of
    parameter sets and SEI (libde265_tpu/decoder.py:25-237)."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self.serial = telemetry.next_request()   # the spans' request id
        self.vps: Dict[int, VPS] = {}
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        self.warning_queue = WarningQueue()
        self.limit_tid = 100
        self.framerate_ratio = 100    # de265_set_framerate_ratio percent
        self._framedrop_tab = None    # percent -> (tid, in-layer ratio)
        self.hash_checks_passed = 0
        self.status = DecodeError.OK

    # ----------------------------------------------------------- warnings
    @property
    def warnings(self) -> List[str]:
        """Readable warning log (strings); typed codes via get_warning()."""
        return self.warning_queue.messages

    def _warn(self, code, detail=""):
        self.warning_queue.add(code, detail)

    def get_warning(self):
        """Pop the oldest typed warning code (de265_get_warning)."""
        return self.warning_queue.get()

    # ------------------------------------------------------------------ API
    def push_data(self, data: bytes, pts=None):
        self.nal_parser.push_data(data, pts)

    def push_nal(self, data: bytes, pts=None):
        self.nal_parser.push_nal(data, pts)

    def flush(self):
        self.nal_parser.flush()

    def decode_all(self):
        while self.decode():
            pass

    # -------------------------------------------- temporal scalability
    # libde265_tpu/decoder.py:133-187 (reference decctx.cc:2132-2223): a
    # percent in [0,100] maps onto the temporal layers, dropping the
    # highest layers first.
    def get_highest_tid(self) -> int:
        for s in self.sps.values():
            return s.max_sub_layers - 1
        for v in self.vps.values():
            return getattr(v, "max_sub_layers", 7) - 1
        return 6

    def _compute_framedrop_table(self):
        highest = self.get_highest_tid()
        tab = [(0, 100)] * 101
        tid_index = {}
        for tid in range(highest, -1, -1):
            lower = 100 * tid // (highest + 1)
            higher = 100 * (tid + 1) // (highest + 1)
            for l in range(lower, higher + 1):
                ratio = 100 * (l - lower) // max(1, higher - lower)
                t = tid
                if t > self.limit_tid:
                    t, ratio = self.limit_tid, 100
                tab[l] = (t, ratio)
            tid_index[tid] = higher
        self._framedrop_tab = tab
        self._framedrop_tid_index = tid_index

    def _calc_tid(self):
        highest = self.get_highest_tid()
        if self._framedrop_tab is None or \
                self._framedrop_tab[100][0] != highest:
            self._compute_framedrop_table()
        tid, _layer_ratio = self._framedrop_tab[self.framerate_ratio]
        self._current_highest_tid = tid

    def set_framerate_ratio(self, percent: int):
        """Decode only `percent` of the frame rate by dropping the
        highest temporal sub-layers (de265_set_framerate_ratio)."""
        self.framerate_ratio = max(0, min(100, percent))
        self._calc_tid()

    def set_limit_tid(self, max_tid: int):
        self.limit_tid = max_tid
        self._framedrop_tab = None
        self._calc_tid()

    def change_framerate(self, more: int) -> int:
        """Step one temporal layer up (+1) or down (-1); returns the new
        framerate ratio percent (de265_change_framerate)."""
        if not self.sps:
            return self.framerate_ratio
        highest = self.get_highest_tid()
        self._calc_tid()
        goal = max(0, min(self._current_highest_tid + more, highest))
        self.framerate_ratio = self._framedrop_tid_index.get(goal, 100)
        self._calc_tid()
        return self.framerate_ratio

    # ------------------------------------------------------------------ NAL
    def _decode_nal(self, nal):
        """libde265_tpu/decoder.py:193-237: layer and temporal gating,
        parameter sets (_param_set), SEI hashes; slices go to
        _slice_nal."""
        t = nal.header.nal_unit_type
        if nal.header.nuh_layer_id != 0:
            return
        gate_tid = getattr(self, "_current_highest_tid", None)
        if gate_tid is None:
            gate_tid = self.limit_tid
        if t <= 31 and nal.header.nuh_temporal_id > gate_tid:
            return
        if t == nal_mod.NAL_VPS_NUT:
            try:
                v = read_vps(nal.data)
            except Exception as e:
                self._warn(W.VPS_HEADER_INVALID, str(e))
                return
            self.vps[v.video_parameter_set_id] = v
        elif t == nal_mod.NAL_SPS_NUT:
            try:
                s = read_sps(nal.data)
            except Exception as e:
                self._warn(W.SPS_HEADER_INVALID, str(e))
                return
            if max(s.bit_depth_luma, s.bit_depth_chroma) > 16:
                # bit_depth_*_minus8 lies in 0..8 (7.4.3.2.1): no sample
                # type holds a deeper plane (a deliberate difference from
                # the JAX decoder, which takes the SPS)
                self._warn(W.SPS_HEADER_INVALID,
                           f"bit depth {s.bit_depth_luma}/"
                           f"{s.bit_depth_chroma} above 16")
                return
            self.sps[s.seq_parameter_set_id] = s
            # the number of temporal layers is now known: recompute the
            # framedrop table (reference decctx.cc:1979)
            self._calc_tid()
            self._param_set(nal, (t, s.seq_parameter_set_id))
        elif t == nal_mod.NAL_PPS_NUT:
            try:
                p = read_pps(nal.data, self.sps)
            except Exception as e:
                self._warn(W.PPS_HEADER_INVALID, str(e))
                return
            self.pps[p.pic_parameter_set_id] = p
            self._param_set(nal, (t, p.pic_parameter_set_id))
        elif t in (nal_mod.NAL_PREFIX_SEI, nal_mod.NAL_SUFFIX_SEI):
            try:
                for msg in parse_sei(nal.data):
                    if msg.picture_hash is not None:
                        self._pending_hash = msg.picture_hash
            except Exception as e:
                self._warn(W.SPS_MISSING_CANNOT_DECODE_SEI, str(e))
        elif t < 32:
            self._slice_nal(nal)

    def _param_set(self, nal, key):
        """A parameter set was stored under `key` ((type, id))."""

    def _read_slice_header(self, nal):
        """The RASL skip and the slice-header checks of
        libde265_tpu/decoder.py:239-262: (sh, sps, pps), or None with the
        JAX decoder's warning."""
        t = nal.header.nal_unit_type
        # RASL pictures after a BLA / stream-initial CRA reference pictures
        # from before the random-access point: skip them
        # (reference: NoRaslOutputFlag handling, decctx.cc:2038-2048)
        if nal_mod.is_rasl(t) and self.no_rasl_output_flag:
            self._warn(W.RASL_PICTURE_SKIPPED,
                       "RASL picture after random access skipped")
            return None
        try:
            sh = read_slice_header(nal.data, nal.header, self.pps, self.sps)
        except KeyError:
            self._warn(W.NONEXISTING_PPS_REFERENCED)
            return None
        except Exception as e:
            self._warn(W.SLICEHEADER_INVALID, str(e))
            return None
        if sh.pic_parameter_set_id not in self.pps:
            self._warn(W.NONEXISTING_PPS_REFERENCED)
            return None
        pps = self.pps[sh.pic_parameter_set_id]
        sps = pps.sps
        if sh.slice_segment_address >= sps.PicSizeInCtbsY or \
                sh.slice_segment_address < 0:
            self._warn(W.SLICE_SEGMENT_ADDRESS_INVALID,
                       str(sh.slice_segment_address))
            return None
        return sh, sps, pps


# ====================================================================
# parse="python": the per-picture path
# ====================================================================
# slice-header fields a dependent slice segment takes from its slice
# (libde265_tpu/decoder.py:277-285)
_INHERITED = (
    "slice_type", "slice_qp_delta", "SliceQPY", "initType",
    "slice_sao_luma_flag", "slice_sao_chroma_flag", "num_ref_idx_l0_active",
    "num_ref_idx_l1_active", "slice_deblocking_filter_disabled_flag",
    "slice_beta_offset", "slice_tc_offset", "slice_cb_qp_offset",
    "slice_cr_qp_offset", "slice_loop_filter_across_slices_enabled_flag",
    "cabac_init_flag", "collocated_from_l0_flag", "collocated_ref_idx",
    "MaxNumMergeCand", "pred_weight", "mvd_l1_zero_flag",
    "slice_temporal_mvp_enabled_flag")


class _DpbPlanes:
    """The Python DPB as the numpy reference reads it (pics[i].planes /
    .plan / .poc), with the planes of the references a frame uses
    fetched from the device beforehand; an entry it does not use has no
    planes."""

    class _P:
        __slots__ = ("planes", "plan", "poc")

    def __init__(self, dpb, planes):
        self.pics = []
        for i, p in enumerate(dpb.pics):
            e = self._P()
            e.planes, e.plan, e.poc = planes.get(i), p.plan, p.poc
            self.pics.append(e)


class PictureDecoder(_NalDecoder):
    """Stream decoder with the lifecycle of the reference C API:
    push_data() / flush() / decode() / get_next_picture(), parsing in
    Python and reconstructing each picture on `device` ("cuda" unless the
    caller asks for "cpu"). get_next_picture returns an
    api.DecodedPicture.

    stats: n_frames (pictures reconstructed), n_host_frames (numpy:
    frame_uses_rext_tools, or a plan the host packing refused),
    n_hybrid_frames, n_concealed_frames (grey after numpy failed too),
    parse_s (host seconds in SliceReader: the slice_parse spans)."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.dpb = DPB()
        self.stream: Optional[PictureStreamDecoder] = None
        self._geometry = None         # stream_geometry of the last SPS
        self.stats = dict(n_frames=0, n_host_frames=0, n_hybrid_frames=0,
                          n_concealed_frames=0, parse_s=0.0)
        self._next_fid = 0            # frame ids, in decode order
        self.handle_cra_as_bla = False
        self.width = 0
        self.height = 0
        self._reset_state()

    def _reset_state(self):
        self.nal_parser = NALParser()
        self.img: Optional[FramePlan] = None  # picture under decode
        self.img_dpb_idx = -1
        self.prev_tid0_poc = 0
        self.poc = 0
        self.first_decoded_picture = True
        self.no_rasl_output_flag = False
        self.last_rap_poc = 0
        self.curr_rps = None          # marked reference sets for current pic
        self.ref_pic_lists = None
        self.wpp_contexts = {}
        self.dep_slice_ctx = None
        self._cur_independent_sh = None
        self._pending_hash = None

    # ------------------------------------------------------------------ API
    def decode(self) -> bool:
        """Decode one NAL; returns True if more work may remain. Sets
        self.status (DecodeError.OK / WAITING_FOR_INPUT /
        IMAGE_BUFFER_FULL), as the reference's stall states
        (decctx.cc:1271-1304)."""
        self.status = DecodeError.OK
        nal = self.nal_parser.pop()
        if nal is None:
            if self.nal_parser.end_of_stream:
                self._finish_picture()
                self.dpb.flush_reorder()
                self._drain_output()
                return False
            self.status = DecodeError.WAITING_FOR_INPUT
            return False
        self._decode_nal(nal)
        self._drain_output()
        return True

    def reset(self):
        """Reset for seeking: drop queued NALs, the picture under decode and
        all DPB state; keep parameter sets (de265_reset, decctx.cc:360-428).
        The next pushed data should start at a RAP."""
        self.dpb.reset()
        self._reset_state()

    def get_next_picture(self):
        """Pop the next picture in output order (an api.DecodedPicture)
        or None."""
        return self._picture(self.dpb.pop_output())

    def queued(self):
        """Pictures waiting in the output queue."""
        return len(self.dpb.output_queue)

    def peek_next_picture(self):
        return self._picture(self.dpb.peek_output())

    @staticmethod
    def _picture(p):
        if p is None:
            return None
        from .api import DecodedPicture
        return DecodedPicture(poc=p.poc, planes=p.output_planes,
                              plan=p.plan, pts=p.pts)

    # ---------------------------------------------------------------- slice
    def _slice_nal(self, nal):
        """libde265_tpu/decoder.py:239-334."""
        got = self._read_slice_header(nal)
        if got is None:
            return
        sh, sps, pps = got
        if sh.first_slice_segment_in_pic_flag:
            self._finish_picture()
            self._start_picture(sh, sps, pps, nal)
        if self.img is None:
            # non-first slice segment without a started picture
            self._warn(W.SLICEHEADER_INVALID,
                       "slice segment before first slice of picture")
            return

        if not sh.dependent_slice_segment_flag:
            sh.SliceAddrRS = sh.slice_segment_address
            self._cur_independent_sh = sh
        else:
            parent = self._cur_independent_sh
            if parent is None:
                # dependent segment with no preceding independent slice
                # (reference guard: slice.cc first-slice checks)
                self._warn(W.DEPENDENT_SLICE_WITH_ADDRESS_ZERO,
                           "dependent slice without independent predecessor")
                return
            sh.SliceAddrRS = parent.SliceAddrRS
            for attr in _INHERITED:
                setattr(sh, attr, getattr(parent, attr))
        self.img.slice_headers.append(sh)

        ref_lists = None
        if sh.slice_type != SLICE_TYPE_I:
            ref_lists = self._construct_ref_lists(sh, sps, pps)
        sh.RefPicList = ref_lists

        # entry-point offsets count the emulation-prevention bytes the NAL
        # payload no longer has (decctx.cc:652-656)
        data_start = sh.header_size_bytes
        slice_data = nal.data[data_start:]
        if sh.entry_point_offsets and nal.skipped:
            sh.entry_point_offsets = _fixup_entry_points(
                sh.entry_point_offsets, nal.skipped, data_start)

        motion = None
        if sh.slice_type != SLICE_TYPE_I:
            motion = MotionDeriver(self, self.img, sh)
        reader = SliceReader(self.img, sh, slice_data, motion=motion,
                             wpp_contexts=self.wpp_contexts,
                             dep_slice_ctx=self.dep_slice_ctx)
        sp = telemetry.span("slice_parse")
        try:
            with sp:
                reader.decode()
        except Exception as e:
            # corrupted slice data: keep whatever was decoded, mark the
            # picture, continue with the next NAL (reference: mark rows
            # complete + integrity DECODING_ERRORS, slice.cc:4988-5001)
            self._warn(W.SLICE_DATA_CORRUPTED,
                       f"POC {self.img.poc}: {type(e).__name__}: {e}")
            if 0 <= self.img_dpb_idx < len(self.dpb.pics):
                self.dpb.pics[self.img_dpb_idx].integrity = 1
            return
        finally:
            self.stats["parse_s"] += sp.seconds
        self.dep_slice_ctx = reader.saved_ctx_for_dep

    # ------------------------------------------------------------- pictures
    def _new_plan(self, sps, pps, poc, nal_type):
        plan = FramePlan(sps, pps, poc=poc)
        plan.frame_id = self._next_fid
        plan.nal_type = nal_type
        self._next_fid += 1
        return plan

    def _start_picture(self, sh, sps, pps, nal):
        t = sh.nal_unit_type
        self._ensure_stream(sps)
        if nal_mod.is_rap(t):
            # NoRaslOutputFlag (spec 8.1): RASL pics after this IRAP must be
            # dropped when decoding (re)starts here
            self.no_rasl_output_flag = bool(
                nal_mod.is_idr(t) or nal_mod.is_bla(t) or
                self.first_decoded_picture or
                (nal_mod.is_cra(t) and self.handle_cra_as_bla))
        self._compute_poc(sh, sps)
        if not nal_mod.is_idr(t):
            if nal_mod.is_rap(t) and self.no_rasl_output_flag:
                # IRAP with NoRaslOutputFlag: all refs become unused before
                # RPS derivation (spec 8.3.2; reference decctx.cc:1441)
                self.dpb.clear_references()
            self._process_rps(sh, sps)
        else:
            self.dpb.clear_references()
            self.curr_rps = {"st_curr_before": [], "st_curr_after": [],
                             "lt_curr": [], "st_follow": []}
        if not self.dpb.has_free():
            # DPB full (reference stall state IMAGE_BUFFER_FULL,
            # decctx.cc:1271-1304). The output queue is pull-based and
            # unbounded, so flush the reorder buffer to free slots instead
            # of stalling; if the stream itself over-references, drop the
            # oldest reference with a warning rather than deadlock.
            self.status = DecodeError.IMAGE_BUFFER_FULL
            while self.dpb.reorder and not self.dpb.has_free():
                self.dpb.output_next()
            if not self.dpb.has_free():
                self._warn(W.DPB_FULL_PICTURE_DROPPED)
                self.dpb.drop_oldest_reference()
        idx = self.dpb.new_picture(self.poc)
        self.img_dpb_idx = idx
        self.img = self._new_plan(sps, pps, self.poc, t)
        self.width = sps.pic_width_in_luma_samples
        self.height = sps.pic_height_in_luma_samples
        pic = self.dpb.pics[idx]
        pic.plan = self.img
        pic.pic_output_flag = bool(sh.pic_output_flag)
        pic.pts = nal.pts       # de265_push_data PTS -> output picture
        self.wpp_contexts = {}
        self.dep_slice_ctx = None

    def _finish_picture(self):
        if self.img is None:
            return
        img = self.img
        pic = self.dpb.pics[self.img_dpb_idx]
        self._reconstruct(img, pic)
        ph = self._pending_hash
        if ph is not None:
            if not verify_picture_hash(self._planes_of(pic), ph,
                                       img.sps.BitDepthY):
                self._warn(W.CHECKSUM_MISMATCH,
                           f"decoded-picture-hash MISMATCH for POC {img.poc}")
            else:
                self.hash_checks_passed += 1
            self._pending_hash = None
        img.compress_motion()
        # output process (decctx.cc:1914-1953)
        sps = img.sps
        self.dpb.insert_reorder(self.img_dpb_idx)
        if not pic.pic_output_flag:
            # remove from reorder, never output
            self.dpb.reorder.remove(self.img_dpb_idx)
            pic.needed_for_output = False
        # index by the operating temporal layer, not the highest coded one
        # (reference: layer-indexed sps_max_num_reorder_pics, decctx.cc:1914)
        tid = getattr(self, "_current_highest_tid", self.limit_tid)
        max_reorder = sps.max_num_reorder_pics[
            min(tid, len(sps.max_num_reorder_pics) - 1)]
        while self.dpb.num_pictures_in_reorder() > max_reorder:
            self.dpb.output_next()
        self.img = None
        self.img_dpb_idx = -1

    # ------------------------------------------------- the device side
    def _ensure_stream(self, sps):
        """A PictureStreamDecoder shaped for `sps`, or None where the
        device program does not carry the SPS (check_slice: a bit depth
        outside 8-12), whose pictures numpy then reconstructs, as the JAX
        decoder does every picture. When the geometry changes, the
        pictures of the old decoder that the DPB still holds are
        downloaded first."""
        geom = stream_geometry(sps)
        if geom == self._geometry:
            return
        if self.stream is not None:
            for p in self.dpb.pics:
                if p.planes is None and p.plan is not None and \
                        p.plan.frame_id in self.stream.frames:
                    p.planes = self.stream.planes_of(p.plan.frame_id)
        self._geometry = geom
        try:
            self.stream = PictureStreamDecoder(sps, self.device)
        except NotImplementedError:
            self.stream = None

    def _retain(self):
        """Keep on the device the pictures the DPB holds (it may read any
        entry, in use or not); evict unused ones first, then
        non-references, then the oldest."""
        if self.stream is None:
            return
        self.stream.retain({
            p.plan.frame_id: (p.in_use(), p.state != UNUSED,
                              p.plan.frame_id)
            for p in self.dpb.pics if p.plan is not None})

    def _planes_of(self, pic):
        """Host [Y, Cb, Cr] of a DPB picture (downloaded from the device
        unless the host made them)."""
        if pic.planes is not None:
            return pic.planes
        return self.stream.planes_of(pic.plan.frame_id)

    def _drain_output(self):
        """Download and crop the pictures bumped into the output queue
        (the device slot of a bumped picture may be reused later)."""
        for p in self.dpb.output_queue:
            if p.output_planes is None:
                p.output_planes = _crop(p.plan, self._planes_of(p))

    def _reconstruct(self, img, pic):
        """Reconstruct the finished picture on the device. A plan that
        the host work refuses (bridge_plan, PictureStreamDecoder.prepare:
        DATA_ERRORS, raised before anything reaches the device) and a
        frame of frame_uses_rext_tools go to the numpy reference, and a
        frame numpy refuses too is concealed grey (libde265_tpu/
        decoder.py:386-395). Whatever the launch raises leaves
        decode()."""
        self._drain_output()
        self._retain()
        st, stream = self.stats, self.stream
        st["n_frames"] += 1
        fid_of = {i: p.plan.frame_id for i, p in enumerate(self.dpb.pics)
                  if p.plan is not None}
        job = None
        try:
            view = bridge_plan(img, img.frame_id, img.nal_type,
                               pic.pic_output_flag, fid_of)
            if stream is not None and not frame_uses_rext_tools(view):
                job = stream.prepare(view)
        except DATA_ERRORS:
            pass
        if job is not None:
            n_hyb = stream.n_hybrid_frames
            stream.launch(job)
            st["n_hybrid_frames"] += stream.n_hybrid_frames - n_hyb
            return
        refs = self._host_refs(img)
        try:
            planes = reconstruct_frame(img, dpb_images=_DpbPlanes(self.dpb,
                                                                 refs))
            st["n_host_frames"] += 1
        except Exception as e:
            # reconstruction of a corrupted plan failed: conceal with grey
            self._warn(W.SLICE_DATA_CORRUPTED,
                       f"POC {img.poc} reconstruction failed: {e}")
            planes = grey_planes(img.sps, img.W, img.H)
            pic.integrity = 1
            st["n_concealed_frames"] += 1
        pic.planes = planes
        if stream is not None:
            stream.insert_host(bridge_plan(img, img.frame_id, -1, False, {}),
                               planes)

    def _host_refs(self, img):
        """DPB index -> host planes of the pictures img's PUs reference
        (downloaded here, outside the concealment's reach)."""
        out = {}
        for pu in img.pus:
            for l in range(2):
                i = pu.ref_dpb[l]
                if not pu.pred_flag[l] or i in out or \
                        not 0 <= i < len(self.dpb.pics):
                    continue
                p = self.dpb.pics[i]
                if p.planes is not None:
                    out[i] = p.planes
                elif p.plan is not None and self.stream is not None and \
                        p.plan.frame_id in self.stream.frames:
                    out[i] = self.stream.planes_of(p.plan.frame_id)
        return out

    # ------------------------------------------------------------ POC (8.3.1)
    def _compute_poc(self, sh, sps):
        t = sh.nal_unit_type
        max_lsb = sps.MaxPicOrderCntLsb
        lsb = sh.slice_pic_order_cnt_lsb
        if nal_mod.is_idr(t):
            self.poc = 0
            self.prev_tid0_poc = 0
            self.first_decoded_picture = False
            self.last_rap_poc = 0
            return
        prev = self.prev_tid0_poc
        prev_lsb = (prev % max_lsb + max_lsb) % max_lsb
        prev_msb = prev - prev_lsb
        if nal_mod.is_rap(t) and (self.first_decoded_picture or
                                  (nal_mod.is_bla(t) or
                                   (nal_mod.is_cra(t) and
                                    self.handle_cra_as_bla))):
            self.poc = lsb
        else:
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            self.poc = msb + lsb
        if sh.nuh_temporal_id == 0 and not nal_mod.is_rasl(t) and \
                not nal_mod.is_radl(t) and \
                not nal_mod.is_sublayer_non_reference(t):
            self.prev_tid0_poc = self.poc
        if nal_mod.is_rap(t):
            self.last_rap_poc = self.poc
        self.first_decoded_picture = False

    # ------------------------------------------------------------ RPS (8.3.2)
    def _process_rps(self, sh, sps):
        rps = sh.slice_rps if sh.slice_rps is not None else \
            (sps.ref_pic_sets[sh.CurrRpsIdx] if sps.ref_pic_sets else None)
        st_before, st_after, st_follow = [], [], []
        lt_curr, lt_follow = [], []
        if rps is not None:
            for d, used in zip(rps.delta_poc_s0, rps.used_s0):
                (st_before if used else st_follow).append(self.poc + d)
            for d, used in zip(rps.delta_poc_s1, rps.used_s1):
                (st_after if used else st_follow).append(self.poc + d)
        max_lsb = sps.MaxPicOrderCntLsb
        for i in range(sh.num_long_term_sps + sh.num_long_term_pics):
            poc_lt = sh.poc_lsb_lt[i]
            has_msb = bool(sh.delta_poc_msb_present_flag[i])
            if has_msb:
                lsb = sh.slice_pic_order_cnt_lsb
                poc_lt = self.poc - sh.delta_poc_msb_cycle_lt[i] * max_lsb - \
                    (lsb - sh.poc_lsb_lt[i])
            used = bool(sh.used_by_curr_pic_lt_flag[i])
            (lt_curr if used else lt_follow).append((poc_lt, has_msb))

        # mark pictures
        dpb = self.dpb
        curr = {"st_curr_before": [], "st_curr_after": [], "lt_curr": [],
                "st_follow": []}
        marked = set()
        for name, pocs in (("st_curr_before", st_before),
                           ("st_curr_after", st_after)):
            for poc in pocs:
                i = dpb.index_with_poc(poc)
                if i < 0:
                    self._warn(W.NONEXISTING_REFERENCE_PICTURE_ACCESSED,
                               f"missing short-term reference POC {poc}")
                    i = self._generate_missing_reference(poc, sps)
                dpb.pics[i].state = SHORT_TERM
                curr[name].append(i)
                marked.add(i)
        for poc in st_follow:
            i = dpb.index_with_poc(poc)
            if i >= 0:
                dpb.pics[i].state = SHORT_TERM
                marked.add(i)
        for poc_lt, has_msb in lt_curr:
            if has_msb:
                i = dpb.index_with_poc(poc_lt)
            else:
                i = dpb.index_with_poc_lsb(poc_lt, max_lsb)
            if i < 0:
                self._warn(W.NONEXISTING_REFERENCE_PICTURE_ACCESSED,
                           f"missing long-term reference POC {poc_lt}")
                i = self._generate_missing_reference(poc_lt, sps)
            dpb.pics[i].state = LONG_TERM
            curr["lt_curr"].append(i)
            marked.add(i)
        for poc_lt, has_msb in lt_follow:
            i = dpb.index_with_poc(poc_lt) if has_msb else \
                dpb.index_with_poc_lsb(poc_lt, max_lsb)
            if i >= 0:
                dpb.pics[i].state = LONG_TERM
                marked.add(i)
        # unmark everything else
        for i, p in enumerate(dpb.pics):
            if p.state != UNUSED and i not in marked and i != self.img_dpb_idx:
                p.state = UNUSED
        self.curr_rps = curr

    def _generate_missing_reference(self, poc, sps):
        """Grey concealment frame (decctx.cc:1408-1434), in the device DPB
        too."""
        idx = self.dpb.new_picture(poc)
        pic = self.dpb.pics[idx]
        pic.needed_for_output = False
        W, H = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        pic.planes = grey_planes(sps, W, H)
        pic.plan = self._new_plan(sps, list(self.pps.values())[0], poc, -1)
        pic.integrity = 1
        if self.stream is not None:
            self._retain()
            self.stream.insert_host(
                bridge_plan(pic.plan, pic.plan.frame_id, -1, False, {}),
                pic.planes)
        return idx

    # ------------------------------------------------------ ref lists (8.3.4)
    def _construct_ref_lists(self, sh, sps, pps):
        curr = self.curr_rps or {"st_curr_before": [], "st_curr_after": [],
                                 "lt_curr": []}
        before = curr["st_curr_before"]
        after = curr["st_curr_after"]
        lt = curr["lt_curr"]
        n_total = len(before) + len(after) + len(lt)
        lists = []
        for l in range(2):
            n_active = sh.num_ref_idx_l0_active if l == 0 \
                else sh.num_ref_idx_l1_active
            if l == 0:
                tmp = before + after + lt
            else:
                tmp = after + before + lt
            if not tmp:
                lists.append([])
                continue
            while len(tmp) < n_active:
                tmp = tmp + tmp  # wrap-around fill
            tmp = tmp[:max(n_active, n_total)]
            mod_flag = sh.ref_pic_list_modification_flag_l0 if l == 0 else \
                sh.ref_pic_list_modification_flag_l1
            entries = sh.list_entry_l0 if l == 0 else sh.list_entry_l1
            base = (before + after + lt) if l == 0 else (after + before + lt)
            if mod_flag:
                full = base
                while len(full) < n_active:
                    full = full + full
                out = [full[e] for e in entries[:n_active]]
            else:
                out = tmp[:n_active]
            lists.append(out)
        # remember long-term-ness for TMVP
        sh.RefIsLongTerm = [[self.dpb.pics[i].state == LONG_TERM for i in ll]
                            for ll in lists]
        sh.RefPOC = [[self.dpb.pics[i].poc for i in ll] for ll in lists]
        return lists


def _crop(plan, planes):
    """The conformance window of plan's SPS applied to planes."""
    sps = plan.sps
    if not sps.conformance_window_flag:
        return planes
    sw, shh = sps.SubWidthC, sps.SubHeightC
    l = sps.conf_win_left_offset * sw
    r = sps.conf_win_right_offset * sw
    t = sps.conf_win_top_offset * shh
    b = sps.conf_win_bottom_offset * shh
    out = [planes[0][t:plan.H - b, l:plan.W - r]]
    cl, cr_, ct, cb = l // sw, r // sw, t // shh, b // shh
    for c in (1, 2):
        h, w = planes[c].shape
        out.append(planes[c][ct:h - cb, cl:w - cr_])
    return out


def _fixup_entry_points(offsets, skipped, data_start):
    """Entry-point offsets count unstripped bytes; convert to offsets within
    the stripped slice-data buffer (decctx.cc:652-656 equivalent)."""
    rel_skips = sorted(s - data_start for s in skipped if s >= data_start)
    fixed = []
    prev_stripped = 0
    acc_unstripped = 0
    for off in offsets:
        acc_unstripped += off
        # stripped position = unstripped - (#skips with unstripped pos < acc)
        # skip k (stripped pos p = rel_skips[k]) has unstripped pos p + k + 1
        n = 0
        for k, p in enumerate(rel_skips):
            if p + k < acc_unstripped:
                n = k + 1
            else:
                break
        stripped_pos = acc_unstripped - n
        fixed.append(stripped_pos - prev_stripped)
        prev_stripped = stripped_pos
    return fixed


# ====================================================================
# parse="native": the segment path
# ====================================================================
@dataclass
class _Pic:
    """A picture of the current segment, in decode order: the pts of the
    NAL of its first slice, and the SEI hash it is checked against."""
    pts: object = None
    hash: object = None


class Decoder(_NalDecoder):
    """Stream decoder with the lifecycle of the reference C API:
    push_data() / flush() / decode() / get_next_picture(), parsing a
    segment at a time with the native front end and reconstructing on
    `device` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._ps_nals = {}            # (type, id) -> NAL bytes, for segments
        # decoded frames by route, summed over segments
        self.stats = dict(n_segments=0, n_frames=0, n_host_frames=0,
                          n_hybrid_frames=0, n_python_segments=0)
        self._output = deque()
        self._reset_stream()

    def _reset_stream(self):
        self.nal_parser = NALParser()
        self._seg = []                # (bytes, NAL) of the current segment
        self._seg_ps = None           # parameter sets at its start
        self._seg_starts = []         # _seg positions that start a picture
        self._seg_pics: List[_Pic] = []
        self._held = []               # (picture index, _seg position,
                                      #  code, detail)
        self._cur: Optional[_Pic] = None
        self._pending_hash = None
        self._cur_independent = False
        self.first_decoded_picture = True
        self.no_rasl_output_flag = False

    def _warn(self, code, detail=""):
        """Queue a warning. While a segment is open it is held, tagged
        with the segment's picture under decode and its place among the
        segment's NALs, so that the segment's decode can queue it in the
        JAX decoder's order among the warnings of the decode
        (_flush_warnings, _decode_python)."""
        if self._seg_pics:
            self._held.append((len(self._seg_pics) - 1, len(self._seg),
                               code, detail))
        else:
            self.warning_queue.add(code, detail)

    # ------------------------------------------------------------------ API
    def decode(self) -> bool:
        """Take one NAL; returns True if more work may remain. At the end
        of the stream (after flush) it decodes the last segment and
        returns False. Sets self.status (DecodeError.OK /
        WAITING_FOR_INPUT)."""
        self.status = DecodeError.OK
        nal = self.nal_parser.pop()
        if nal is None:
            if self.nal_parser.end_of_stream:
                self._finish_picture()
                self._decode_segment()
                return False
            self.status = DecodeError.WAITING_FOR_INPUT
            return False
        self._decode_nal(nal)
        return True

    def reset(self):
        """Reset for seeking: drop the buffered bytes, the current segment
        and the output queue; keep the parameter sets (de265_reset). The
        next pushed data should start at a RAP."""
        for _, _, code, detail in self._held:
            self.warning_queue.add(code, detail)
        self._reset_stream()
        self._output.clear()

    def get_next_picture(self):
        """Pop the next picture in output order (an api.DecodedPicture)
        or None."""
        return self._output.popleft() if self._output else None

    def queued(self):
        """Pictures waiting in the output queue."""
        return len(self._output)

    def peek_next_picture(self):
        return self._output[0] if self._output else None

    # ------------------------------------------------------------------ NAL
    def _param_set(self, nal, key):
        """Keep the parameter set's bytes for the prefix of later segments;
        within a segment it also goes into the segment at its place."""
        raw = escape(nal)
        self._ps_nals[key] = raw
        if self._seg:
            self._seg.append((raw, nal))

    def _slice_nal(self, nal):
        """libde265_tpu/decoder.py:239-285 up to the slice data: the RASL
        skip, the slice-header checks, the picture start (where a segment
        may end) and the dependent-slice check."""
        got = self._read_slice_header(nal)
        if got is None:
            return
        sh = got[0]
        t = nal.header.nal_unit_type
        if sh.first_slice_segment_in_pic_flag:
            self._finish_picture()
            if nal_mod.is_idr(t) or nal_mod.is_bla(t):
                self._decode_segment()
            self._start_picture(t, nal)
        if self._cur is None:
            self._warn(W.SLICEHEADER_INVALID,
                       "slice segment before first slice of picture")
            return
        if not sh.dependent_slice_segment_flag:
            self._cur_independent = True
        elif not self._cur_independent:
            self._warn(W.DEPENDENT_SLICE_WITH_ADDRESS_ZERO,
                       "dependent slice without independent predecessor")
            return
        if not self._seg:
            self._seg_ps = (dict(self.vps), dict(self.sps), dict(self.pps),
                            list(self._ps_nals.values()))
        self._seg.append((escape(nal), nal))

    def _start_picture(self, t, nal):
        if nal_mod.is_rap(t):
            # NoRaslOutputFlag (spec 8.1): RASL pictures after this IRAP
            # are dropped when decoding (re)starts here
            self.no_rasl_output_flag = bool(
                nal_mod.is_idr(t) or nal_mod.is_bla(t)
                or self.first_decoded_picture)
        self.first_decoded_picture = False
        self._cur = _Pic(pts=nal.pts)
        self._seg_pics.append(self._cur)
        self._seg_starts.append(len(self._seg))

    def _finish_picture(self):
        """The pending SEI hash belongs to the picture under decode, as in
        libde265_tpu/decoder.py:396-404; it is checked when the segment
        is decoded."""
        if self._cur is None:
            return
        self._cur.hash = self._pending_hash
        self._pending_hash = None
        self._cur = None

    # -------------------------------------------------------------- segment
    def _decode_segment(self):
        """Parse and decode the current segment; its pictures join the
        output queue in output order. A segment the native front end
        refuses (ValueError), or one of whose frames the host work
        refuses before its launches (device_stream.HostDataError), goes
        to _decode_python; any other error of the decode leaves
        decode(). Spans: segment (n: the pictures it queued), with
        param_sets, the native parse and api._decode_plans inside."""
        seg, pics, held = self._seg, self._seg_pics, self._held
        starts, ps = self._seg_starts, self._seg_ps
        self._seg, self._seg_pics, self._held = [], [], []
        self._seg_starts, self._seg_ps = [], None
        if not pics:
            return
        if not seg:
            self._flush_warnings(held, [], {}, None)
            return
        with telemetry.span("segment") as sp:
            queued = self.queued()
            self._decode_segment_data(seg, starts, pics, held, ps)
            sp.n = self.queued() - queued

    def _decode_segment_data(self, seg, starts, pics, held, ps):
        """_decode_segment's work on a segment that holds NALs."""
        from .api import _decode_plans, _param_sets
        from .native_frontend import NativeFrontend
        data = b"".join(_START + raw for raw in ps[3] + [r for r, _ in seg])
        with telemetry.span("param_sets"):
            spss, ppss = _param_sets(data)
        try:
            plans = NativeFrontend().parse(data, spss, ppss)
        except ValueError:
            self._decode_python(seg, starts, pics, held, ps)
            return
        if not plans:
            self._flush_warnings(held, [], {}, None)
            return
        # the front end starts a frame for every first slice it is given,
        # and appends a grey frame (nal_type -1) after a frame for each
        # reference it misses
        coded = [p for p in plans if p.nal_type != -1]
        meta = {p.frame_id: m for p, m in zip(coded, pics)}
        keep = {fid for fid, m in meta.items() if m.hash is not None}
        try:
            out, dec = _decode_plans(plans, self.device, keep=keep)
        except HostDataError:
            self._decode_python(seg, starts, pics, held, ps)
            return
        self._flush_warnings(held, plans, meta, dec)
        for pic in out:
            m = meta.get(pic.plan.frame_id)
            pic.pts = m.pts if m is not None else None
            self._output.append(pic)
        st = self.stats
        st["n_segments"] += 1
        st["n_frames"] += len(plans)
        st["n_host_frames"] += dec.n_host_frames
        st["n_hybrid_frames"] += dec.n_hybrid_frames

    def _decode_python(self, seg, starts, pics, held, ps):
        """Decode a segment again through the per-picture path
        (PictureDecoder on the same device) from its NALs, with the
        parameter sets of its start: the held warnings at their places
        among the NALs, each picture's SEI hash set before the NAL that
        finishes it; its pictures join the output queue, its warnings
        the warning queue."""
        inner = PictureDecoder(self.device)
        inner.warning_queue = self.warning_queue
        inner.vps, inner.sps, inner.pps = (dict(d) for d in ps[:3])
        inner.limit_tid, inner.framerate_ratio = self.limit_tid, \
            self.framerate_ratio
        if hasattr(self, "_current_highest_tid"):
            inner._current_highest_tid = self._current_highest_tid
        held = deque(sorted(held, key=lambda h: h[1]))
        first = set(starts)
        k = -1
        for i, (_, nal) in enumerate(seg):
            while held and held[0][1] <= i:
                self.warning_queue.add(*held.popleft()[2:])
            if i in first:
                if k >= 0:
                    inner._pending_hash = pics[k].hash
                k += 1
            inner._decode_nal(nal)
        for h in held:
            self.warning_queue.add(*h[2:])
        inner._pending_hash = pics[k].hash if k >= 0 else None
        inner._finish_picture()
        inner.dpb.flush_reorder()
        inner._drain_output()
        while True:
            pic = inner.get_next_picture()
            if pic is None:
                break
            self._output.append(pic)
        st, ist = self.stats, inner.stats
        st["n_segments"] += 1
        st["n_python_segments"] += 1
        for key in ("n_frames", "n_host_frames", "n_hybrid_frames"):
            st[key] += ist[key]
        self.hash_checks_passed += inner.hash_checks_passed

    def _flush_warnings(self, held, plans, meta, dec):
        """Queue the segment's held warnings and those of its decode in the
        JAX decoder's order: when picture k starts, the hash check of
        picture k - 1, then k's missing references (its concealment
        frames follow it in `plans`), then the warnings held under k."""
        add = self.warning_queue.add
        tagged = {}
        for k, _, code, detail in held:
            tagged.setdefault(k, []).append((code, detail))

        def finish(k, plan):
            for code, detail in tagged.pop(k, ()):
                add(code, detail)
            m = meta.get(plan.frame_id)
            if m is None or m.hash is None:
                return
            with telemetry.span("hash_check"):
                ok = verify_picture_hash(dec.planes_of(plan.frame_id),
                                         m.hash, plan.sps.BitDepthY)
            if ok:
                self.hash_checks_passed += 1
            else:
                add(W.CHECKSUM_MISMATCH,
                    f"decoded-picture-hash MISMATCH for POC {plan.poc}")

        k, prev = -1, None
        for p in plans:
            if p.nal_type == -1:
                add(W.NONEXISTING_REFERENCE_PICTURE_ACCESSED,
                    f"missing reference POC {p.poc}")
                continue
            if prev is not None:
                finish(k, prev)
            k, prev = k + 1, p
        if prev is not None:
            finish(k, prev)
        for k in sorted(tagged):
            for code, detail in tagged[k]:
                add(code, detail)
