"""GOP-sharded decoding: one closed GOP per entry of a device list
(PyTorch).

Counterpart of libde265_tpu/parallel/gop_shard.py (split_gop_plans,
decode_gops_sharded); gop_parallel.py holds split_gops and
decode_gop_device, the entry point over decode_gops. An IRAP
picture is a restart point: a closed GOP references nothing before it,
so GOPs decode as pure data parallelism with no communication. The JAX
package runs one shard_map program over a mesh, each shard with a
private DPB and tile-table carry; here each GOP gets its own
DeviceStreamDecoder (its own DPB stacks and tile tables) on
devices[g % len(devices)], and the single-device frame program with its
kernels, unchanged. The list may repeat a device: on one card each entry
has a CUDA stream of its own, so the GOPs of one wave (one per entry)
are queued on different streams and can overlap on the card. GOPs go in
waves of len(devices); a wave's pictures are downloaded before the next
starts, so at most len(devices) decoders hold device memory.

A GOP that does not start with a pure-intra IRAP, holds a frame the
frame program does not take (frame_compatible), or references a frame
outside itself is refused with ValueError, where the JAX function
asserts; no GOP is decoded another way.
"""
import contextlib

import torch

from ..device import resolve
from ..device_stream import DeviceStreamDecoder
from ..packing import frame_compatible, frame_has_intra, frame_has_mc
from .gop_parallel import split_gops  # noqa: F401  (one copy, there)


def split_gop_plans(plans):
    """Group parsed plans into closed GOPs (each starts at an IRAP)."""
    gops = []
    cur = []
    for p in plans:
        if p.nal_type != -1 and 16 <= p.nal_type <= 23 and cur:
            gops.append(cur)
            cur = []
        cur.append(p)
    if cur:
        gops.append(cur)
    return gops


def check_gop(gop, gi):
    """Raise ValueError unless the frame program decodes GOP `gi` alone:
    it starts with a pure-intra IRAP, every frame is frame_compatible and
    references only frames of the GOP."""
    first = gop[0]
    if first.nal_type == -1 or not 16 <= first.nal_type <= 23 \
            or not frame_has_intra(first) or frame_has_mc(first):
        raise ValueError(f"GOP {gi} does not start with a pure-intra IRAP")
    fids = set()
    for p in gop:
        if p.nal_type == -1 or not frame_compatible(p):
            raise ValueError(f"GOP {gi}: frame {p.frame_id} (POC {p.poc}) "
                             f"is not one the frame program takes")
        if DeviceStreamDecoder.ref_fids(p) - fids:
            raise ValueError(f"GOP {gi}: frame {p.frame_id} (POC {p.poc}) "
                             f"references a frame outside the GOP")
        fids.add(p.frame_id)


def decode_gops(plans, sps, devices):
    """Decode a closed-GOP stream, GOP g on devices[g % len(devices)].
    Returns (pics, stats): the DecodedPictures in the JAX
    decode_gop_device order (GOP by GOP, by POC within a GOP), and a
    dict with n_gops, n_frames, n_host_frames, n_hybrid_frames (both 0:
    check_gop refuses the frames of those paths) and pack_s."""
    from ..api import _RefShim, _order_and_crop
    devs = [resolve(d) for d in devices]
    if not devs:
        raise ValueError("decode_gops: empty device list")
    gops = split_gop_plans(plans)
    for gi, g in enumerate(gops):
        check_gop(g, gi)
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    pics = []
    stats = dict(n_gops=len(gops), n_frames=len(plans), n_host_frames=0,
                 n_hybrid_frames=0, pack_s=0.0)
    for base in range(0, len(gops), len(devs)):
        wave = []
        for lane, g in enumerate(gops[base:base + len(devs)]):
            with _on(streams[lane]):
                dec = DeviceStreamDecoder(g, sps, devs[lane])
                dec.decode_all()
            wave.append((lane, g, dec))
        for lane, g, dec in wave:
            refs = _RefShim()
            done = [p for p in g if p.output_flag]
            with _on(streams[lane]):
                for p in done:
                    refs.add(p.frame_id, p, dec.planes_of(p.frame_id))
            pics.extend(_order_and_crop(done, refs))
            stats["n_host_frames"] += dec.n_host_frames
            stats["n_hybrid_frames"] += dec.n_hybrid_frames
            stats["pack_s"] += dec.pack_seconds
    return pics, stats


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()
