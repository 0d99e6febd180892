"""Public entry points of the port.

decode_stream_native: counterpart of libde265_tpu.api.decode_stream_native
(backend="device"): the C++ front end (native/libhevc_frontend.so) parses
the whole stream, the device-resident decoder reconstructs it on
`device`, and the pictures come back in output order with the
conformance window applied.

The push API, the de265_* C surface (libde265/de265.h:190-430) in
pythonic form, as libde265_tpu/api.py:56-124 has it, over the port's
decoder.Decoder (parse="native", the default) or decoder.PictureDecoder
(parse="python", the JAX decoder's own per-picture path), on "cuda"
unless the caller asks for "cpu":

    dec = new_decoder()           # or new_decoder(parse="python")
    push_data(dec, chunk, pts)
    flush_data(dec)
    while decode(dec): ...
    pic = get_next_picture(dec)   # -> DecodedPicture or None

`DecodedPicture`, `_RefShim` and `_order_and_crop` are copies of
libde265_tpu/api.py:18-53,127-143,203-229.
"""
import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import telemetry
from .bitstream.nal import split_annexb
from .bitstream.paramsets import read_sps, read_pps
from .decoder import Decoder, PictureDecoder
from .device import resolve
from .device_stream import DeviceStreamDecoder, ShardedStreamDecoder
from .native_frontend import NativeFrontend
from .parallel.gop_shard import decode_gops


@dataclass
class DecodedPicture:
    poc: int
    planes: list          # [Y, Cb, Cr] numpy arrays (conformance-cropped)
    plan: object = None   # decode-plan metadata (FramePlan) for structure
                          # inspection
    pts: object = None    # presentation timestamp (de265_get_image_PTS)

    @property
    def width(self):
        return self.planes[0].shape[1]

    @property
    def height(self):
        return self.planes[0].shape[0]

    @property
    def chroma_format(self):
        """de265_get_chroma_format: 0 mono, 1 4:2:0, 2 4:2:2, 3 4:4:4."""
        if self.plan is not None:
            return self.plan.sps.ChromaArrayType
        h, w = self.planes[0].shape
        if self.planes[1].size == 0:
            return 0
        ch, cw = self.planes[1].shape
        if cw * 2 == w:
            return 1 if ch * 2 == h else 2
        return 3

    def plane_md5(self, idx):
        """Per-plane MD5, the reference's SEI decoded-picture-hash oracle
        (sei.cc:251-270)."""
        return hashlib.md5(np.ascontiguousarray(self.planes[idx]).tobytes()).hexdigest()

    def to_yuv_bytes(self):
        return b"".join(np.ascontiguousarray(p).tobytes() for p in self.planes)


class _RefShim:
    """Maps decode-order frame ids to reconstructed pictures for MC."""
    class _P:
        __slots__ = ("planes", "plan", "poc")

        def __init__(self):
            self.planes = None
            self.plan = None
            self.poc = 0

    def __init__(self):
        self.pics = {}

    def add(self, fid, plan, planes):
        p = self._P()
        p.plan, p.planes, p.poc = plan, planes, plan.poc
        self.pics[fid] = p


def _order_and_crop(done, refs):
    """Reorder decoded plans by POC within IDR-delimited groups, apply the
    conformance window, return DecodedPictures."""
    out = []
    group = []
    for plan in done:
        if plan.nal_type in (19, 20) and group:  # IDR starts new group
            out.extend(sorted(group, key=lambda p: p.poc))
            group = []
        group.append(plan)
    out.extend(sorted(group, key=lambda p: p.poc))
    pics = []
    for plan in out:
        planes = refs.pics[plan.frame_id].planes
        sps = plan.sps
        if sps.conformance_window_flag:
            sw, shh = sps.SubWidthC, sps.SubHeightC
            l = sps.conf_win_left_offset * sw
            r = sps.conf_win_right_offset * sw
            t = sps.conf_win_top_offset * shh
            b = sps.conf_win_bottom_offset * shh
            cl, cr_, ct, cb2 = l // sw, r // sw, t // shh, b // shh
            planes = [planes[0][t:plan.H - b, l:plan.W - r],
                      planes[1][ct:planes[1].shape[0] - cb2, cl:planes[1].shape[1] - cr_],
                      planes[2][ct:planes[2].shape[0] - cb2, cl:planes[2].shape[1] - cr_]]
        pics.append(DecodedPicture(poc=plan.poc, planes=planes, plan=plan))
    return pics


def _param_sets(data):
    """The Python-parsed SPS and PPS maps of an Annex-B stream (the plans'
    derived values come from these)."""
    spss, ppss = {}, {}
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        try:
            if t == 33:
                s = read_sps(u.data)
                spss[s.seq_parameter_set_id] = s
            elif t == 34:
                p = read_pps(u.data, spss)
                ppss[p.pic_parameter_set_id] = p
        except (ValueError, IndexError, KeyError):
            # corrupted/truncated parameter set: skip the unit and decode
            # what remains (decctx.cc:1593-1595)
            continue
    return spss, ppss


def _parse(data):
    return NativeFrontend().parse(data, *_param_sets(data))


def _conceal_first(plans):
    """The plan list with each concealment frame (nal_type -1: a grey
    stand-in for a missing reference) moved before the frame whose
    reference set asked for it. The front end appends it after that
    frame, which then references a frame not yet decoded."""
    out, at = [], 0
    for p in plans:
        if p.nal_type == -1:
            out.insert(at, p)
            at += 1
        else:
            at = len(out)
            out.append(p)
    return out


def _decode_plans(plans, dev, keep=(), tile_devices=None):
    """Decode a parsed plan list on `dev` (or on tile_devices through
    ShardedStreamDecoder), synchronised, concealment frames first
    (_conceal_first). Frames in `keep` stay readable through
    dec.planes_of after it, as the output frames do. Returns
    (DecodedPictures in output order, decoder). Spans: decode_plans (n:
    frames) around it all, sync around the wait for the device."""
    with telemetry.span("decode_plans", len(plans)):
        plans = _conceal_first(plans)
        if tile_devices is None:
            dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
        else:
            dec = ShardedStreamDecoder(plans, plans[0].sps, tile_devices)
        for fid in keep:
            dec.last_use[fid] = len(plans)
        dec.decode_all()
        with telemetry.span("sync"):
            for d in getattr(dec, "devices", [dec.device]):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        done = [p for p in plans if p.nal_type != -1 and p.output_flag]
        refs = _RefShim()
        for plan in done:
            refs.add(plan.frame_id, plan, dec.planes_of(plan.frame_id))
        return _order_and_crop(done, refs), dec


def decode_stream_native(data: bytes, device="cuda", stats=None,
                         tile_devices=None, gop_devices=None):
    """Decode `data` on `device` ("cuda", "cuda:N" or "cpu"); returns
    DecodedPicture objects in output order. Asking for CUDA where there
    is none raises.

    tile_devices: None, or one device per tile column of the stream
    (e.g. ["cuda:0"] * 4, or ["cuda:0", "cuda:1"]): decode through
    ShardedStreamDecoder, whose pure-inter frames run as one strip per
    tile column on its device; `device` is then not used.

    stats: optional dict, filled with host-clock seconds of the stages
    (parse_s; decode_s: the device decode including packing and the
    download of the output pictures, synchronised; pack_s: the packing
    part of it) and the frame counts (n_frames; n_host_frames: frames
    the numpy reference reconstructed; n_hybrid_frames: frames of the
    hybrid device path, device_decode.py; n_strip_frames: frames decoded
    as tile-column strips).

    gop_devices: None, or a device list (e.g. ["cuda:0"] * 4): decode
    each closed GOP on its own entry of the list, with a DPB of its own
    (parallel/gop_shard.py); a GOP that does not start with a pure-intra
    IRAP, or that holds a frame the frame program does not take, raises
    ValueError. `device` is then not used; stats also get n_gops."""
    if tile_devices is not None and gop_devices is not None:
        raise ValueError("give tile_devices or gop_devices, not both")
    dev = resolve(device) if tile_devices is None and gop_devices is None \
        else None
    t0 = time.perf_counter()
    plans = _parse(data)
    t1 = time.perf_counter()
    if gop_devices is not None:
        pics, st = decode_gops(plans, plans[0].sps if plans else None,
                               gop_devices)
        if stats is not None:
            stats.update(st, parse_s=t1 - t0,
                         decode_s=time.perf_counter() - t1,
                         n_strip_frames=0)
        return pics
    pics, dec = _decode_plans(plans, dev, tile_devices=tile_devices) \
        if plans else ([], None)
    t2 = time.perf_counter()
    if stats is not None:
        stats.update(parse_s=t1 - t0, decode_s=t2 - t1,
                     pack_s=dec.pack_seconds if dec else 0.0,
                     n_frames=len(plans),
                     n_host_frames=dec.n_host_frames if dec else 0,
                     n_hybrid_frames=dec.n_hybrid_frames if dec else 0,
                     n_strip_frames=getattr(dec, "n_strip_frames", 0))
    return pics


def new_decoder(parse="native", **kw):
    """A push decoder on `device` ("cuda" unless given). parse="native"
    (decoder.Decoder): the slices parsed by the C++ front end a segment
    (IDR or BLA to the next) at a time; parse="python"
    (decoder.PictureDecoder): the JAX decoder's own path, every slice
    parsed in Python and each picture reconstructed on the device when
    it ends, output one picture at a time as the DPB bumps it.

    Each call of the push API below runs in a telemetry span
    "api.<call>" with the decoder's serial number as its request id;
    api.decode's n is the number of pictures the call added to the
    output queue."""
    with telemetry.span("api.new_decoder") as s:
        if parse == "native":
            dec = Decoder(**kw)
        elif parse == "python":
            dec = PictureDecoder(**kw)
        else:
            raise ValueError(f"parse={parse!r}: 'native' or 'python'")
        s.request = dec.serial
        return dec


def push_data(dec: Decoder, data: bytes, pts=None):
    with telemetry.span("api.push_data", len(data), dec.serial):
        dec.push_data(data, pts)


def push_nal(dec: Decoder, data: bytes, pts=None):
    dec.push_nal(data, pts)


def flush_data(dec: Decoder):
    with telemetry.span("api.flush_data", 0, dec.serial):
        dec.flush()


def decode(dec: Decoder) -> bool:
    with telemetry.span("api.decode", 0, dec.serial) as s:
        queued = dec.queued()
        more = dec.decode()
        s.n = dec.queued() - queued
        return more


def reset(dec: Decoder):
    """Reset decoder state for seeking (de265_reset)."""
    with telemetry.span("api.reset", 0, dec.serial):
        dec.reset()


def get_warning(dec: Decoder):
    """Pop the oldest typed warning code or None (de265_get_warning)."""
    return dec.get_warning()


def get_next_picture(dec: Decoder):
    """Pop the next DecodedPicture in output order, or None."""
    with telemetry.span("api.get_next_picture", 0, dec.serial):
        return dec.get_next_picture()


def peek_next_picture(dec: Decoder):
    """Front of the output queue WITHOUT removing it
    (de265_peek_next_picture); pair with release_next_picture."""
    return dec.peek_next_picture()


def release_next_picture(dec: Decoder):
    """Drop the front of the output queue (de265_release_next_picture)."""
    dec.get_next_picture()


def decode_stream(data: bytes, stats=None, **kw):
    """Convenience: decode a whole Annex-B stream through the push API;
    returns the list of pictures. kw go to new_decoder (device="cuda"
    and parse="native" unless given); stats, if a dict, gets the
    decoder's counts (its .stats)."""
    dec = new_decoder(**kw)
    dec.push_data(data)
    dec.flush()
    out = []
    while True:
        more = dec.decode()
        while True:
            pic = get_next_picture(dec)
            if pic is None:
                break
            out.append(pic)
        if not more:
            break
    if stats is not None:
        stats.update(dec.stats)
    return out
