"""The push decoder of the port: the surface of libde265_tpu.decoder.Decoder
(push_data / push_nal / flush / decode / reset / get_warning /
get_next_picture, the temporal-layer controls, SEI picture-hash checks,
typed warnings), decoding on a device.

The JAX Decoder parses in Python (CABAC included) one NAL per decode()
and reconstructs each picture with numpy. This one keeps the NAL-level
work in Python (parameter sets, SEI hashes, RASL skipping, temporal-layer
gating, slice-header checks) and hands the slices to the C++ front end
a segment at a time: a segment runs from one IDR or BLA picture to the
next (never cut at a CRA: its RASL pictures reference pictures before
it). When a segment ends (at the next IDR / BLA, or at the end of the
stream after flush), the front end parses the parameter sets and the
segment's NALs as one stream, and a DeviceStreamDecoder on the decoder's
device reconstructs it: frames route to the frame program, the hybrid
device path or numpy exactly as api.decode_stream_native routes them.

Documented difference: pictures come out a segment at a time, not one
NAL at a time. Their order and contents, their pts, the hash checks and
the warnings are the JAX decoder's; only the decode() call after which a
picture appears may differ (the warnings of a segment's hash checks come
when it is decoded). Not carried: grey concealment of a picture whose
reconstruction fails (libde265_tpu/decoder.py:386-395; an error on the
device raises here), and the handling of slices that the native parser
rejects although the Python slice-header parser takes them (the segment
then gives SLICE_DATA_CORRUPTED and no pictures).
"""
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from .bitstream import nal as nal_mod
from .bitstream.nal import NALParser
from .bitstream.paramsets import PPS, SPS, VPS, read_pps, read_sps, read_vps
from .bitstream.sei import parse_sei, verify_picture_hash
from .bitstream.sliceheader import read_slice_header
from .device import resolve
from .errors import DecodeError, Warning as W, WarningQueue

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


@dataclass
class _Pic:
    """A picture of the current segment, in decode order: the pts of the
    NAL of its first slice, and the SEI hash it is checked against."""
    pts: object = None
    hash: object = None


class Decoder:
    """Stream decoder with the lifecycle of the reference C API:
    push_data() / flush() / decode() / get_next_picture(), reconstructing
    on `device` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self.vps: Dict[int, VPS] = {}
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        self._ps_nals = {}            # (type, id) -> NAL bytes, for segments
        self.warning_queue = WarningQueue()
        self.limit_tid = 100
        self.framerate_ratio = 100    # de265_set_framerate_ratio percent
        self._framedrop_tab = None    # percent -> (tid, in-layer ratio)
        self.hash_checks_passed = 0
        self.status = DecodeError.OK
        # decoded frames by route, summed over segments
        self.stats = dict(n_segments=0, n_frames=0, n_host_frames=0,
                          n_hybrid_frames=0)
        self._output = deque()
        self._reset_stream()

    def _reset_stream(self):
        self.nal_parser = NALParser()
        self._seg = []                # NAL bytes of the current segment
        self._seg_pics: List[_Pic] = []
        self._held = []               # (picture index, code, detail)
        self._cur: Optional[_Pic] = None
        self._pending_hash = None
        self._cur_independent = False
        self.first_decoded_picture = True
        self.no_rasl_output_flag = False

    # ----------------------------------------------------------- warnings
    @property
    def warnings(self) -> List[str]:
        """Readable warning log (strings); typed codes via get_warning()."""
        return self.warning_queue.messages

    def _warn(self, code, detail=""):
        """Queue a warning. While a segment is open it is held, tagged
        with the segment's picture under decode, so that the segment's
        decode can queue it in the JAX decoder's order among the
        warnings of the decode (_flush_warnings)."""
        if self._seg_pics:
            self._held.append((len(self._seg_pics) - 1, code, detail))
        else:
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
        for _, code, detail in self._held:
            self.warning_queue.add(code, detail)
        self._reset_stream()
        self._output.clear()

    def decode_all(self):
        while self.decode():
            pass

    def get_next_picture(self):
        """Pop the next picture in output order (an api.DecodedPicture)
        or None."""
        return self._output.popleft() if self._output else None

    def peek_next_picture(self):
        return self._output[0] if self._output else None

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
        """libde265_tpu/decoder.py:193-237, with the slices collected for
        the segment instead of parsed."""
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
            self.sps[s.seq_parameter_set_id] = s
            self._calc_tid()
            self._add_param_set(nal, (t, s.seq_parameter_set_id))
        elif t == nal_mod.NAL_PPS_NUT:
            try:
                p = read_pps(nal.data, self.sps)
            except Exception as e:
                self._warn(W.PPS_HEADER_INVALID, str(e))
                return
            self.pps[p.pic_parameter_set_id] = p
            self._add_param_set(nal, (t, p.pic_parameter_set_id))
        elif t in (nal_mod.NAL_PREFIX_SEI, nal_mod.NAL_SUFFIX_SEI):
            try:
                for msg in parse_sei(nal.data):
                    if msg.picture_hash is not None:
                        self._pending_hash = msg.picture_hash
            except Exception as e:
                self._warn(W.SPS_MISSING_CANNOT_DECODE_SEI, str(e))
        elif t < 32:
            self._slice_nal(nal)

    def _add_param_set(self, nal, key):
        """Keep the parameter set's bytes for the prefix of later segments;
        within a segment it also goes into the segment at its place."""
        raw = escape(nal)
        self._ps_nals[key] = raw
        if self._seg:
            self._seg.append(raw)

    def _slice_nal(self, nal):
        """libde265_tpu/decoder.py:239-285 up to the slice data: the RASL
        skip, the slice-header checks, the picture start (where a segment
        may end) and the dependent-slice check."""
        t = nal.header.nal_unit_type
        if nal_mod.is_rasl(t) and self.no_rasl_output_flag:
            self._warn(W.RASL_PICTURE_SKIPPED,
                       "RASL picture after random access skipped")
            return
        try:
            sh = read_slice_header(nal.data, nal.header, self.pps, self.sps)
        except KeyError:
            self._warn(W.NONEXISTING_PPS_REFERENCED)
            return
        except Exception as e:
            self._warn(W.SLICEHEADER_INVALID, str(e))
            return
        if sh.pic_parameter_set_id not in self.pps:
            self._warn(W.NONEXISTING_PPS_REFERENCED)
            return
        sps = self.pps[sh.pic_parameter_set_id].sps
        if sh.slice_segment_address >= sps.PicSizeInCtbsY or \
                sh.slice_segment_address < 0:
            self._warn(W.SLICE_SEGMENT_ADDRESS_INVALID,
                       str(sh.slice_segment_address))
            return
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
            self._seg = list(self._ps_nals.values())
        self._seg.append(escape(nal))

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
        output queue in output order."""
        from .api import _decode_plans, _param_sets
        from .native_frontend import NativeFrontend
        seg, pics, held = self._seg, self._seg_pics, self._held
        self._seg, self._seg_pics, self._held = [], [], []
        if not pics:
            return
        data = b"".join(_START + raw for raw in seg)
        spss, ppss = _param_sets(data)
        try:
            plans = NativeFrontend().parse(data, spss, ppss)
        except ValueError as e:
            self._flush_warnings(held, [], {}, None)
            self._warn(W.SLICE_DATA_CORRUPTED,
                       f"segment of {len(pics)} pictures: {e}")
            return
        # the front end starts a frame for every first slice it is given,
        # and appends a grey frame (nal_type -1) after a frame for each
        # reference it misses
        coded = [p for p in plans if p.nal_type != -1]
        meta = {p.frame_id: m for p, m in zip(coded, pics)}
        keep = {fid for fid, m in meta.items() if m.hash is not None}
        if not plans:
            self._flush_warnings(held, [], {}, None)
            return
        out, dec = _decode_plans(plans, self.device, keep=keep)
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

    def _flush_warnings(self, held, plans, meta, dec):
        """Queue the segment's held warnings and those of its decode in the
        JAX decoder's order: when picture k starts, the hash check of
        picture k - 1, then k's missing references (its concealment
        frames follow it in `plans`), then the warnings held under k."""
        add = self.warning_queue.add
        tagged = {}
        for k, code, detail in held:
            tagged.setdefault(k, []).append((code, detail))

        def finish(k, plan):
            for code, detail in tagged.pop(k, ()):
                add(code, detail)
            m = meta.get(plan.frame_id)
            if m is None or m.hash is None:
                return
            if verify_picture_hash(dec.planes_of(plan.frame_id), m.hash,
                                   plan.sps.BitDepthY):
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
