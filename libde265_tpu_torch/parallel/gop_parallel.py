"""GOP-level parallel decoding: split an Annex-B stream at IRAP pictures
and decode the segments concurrently (PyTorch).

Counterpart of libde265_tpu/parallel/gop_parallel.py. A random-access
point (IDR / BLA / CRA) is a natural shard boundary: each segment,
prefixed with the stream's parameter sets, decodes on its own.

Two routes, tried in the JAX function's order:
- "device": one native parse and the GOP-sharded decoder
  (gop_shard.decode_gops), one closed GOP per entry of a device list, on
  one host thread. It refuses (ValueError) a stream whose GOPs are not
  closed or hold a frame the frame program does not take.
- "workers": one process per segment, spawned (CUDA does not survive a
  fork), each parsing its own segment and decoding it with
  api.decode_stream_native on its entry of the device list, so a frame
  the frame program refuses still decodes (hybrid or numpy, as that
  entry point routes it). The JAX package calls this route "numpy"
  because its workers reconstruct on the host; these decode on their
  devices.
"""
import multiprocessing as mp
import time

from ..bitstream.nal import is_bla, is_cra, is_idr, is_vcl
from ..device import resolve


def split_gops(stream: bytes):
    """Split an Annex-B stream into self-contained segments, each starting
    with the parameter sets + one IRAP. Returns list of byte strings."""
    units = []
    i = 0
    n = len(stream)
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        start = j - 1 if j > 0 and stream[j - 1] == 0 else j
        k = stream.find(b"\x00\x00\x01", j + 3)
        end = n if k < 0 else (k - 1 if stream[k - 1] == 0 else k)
        t = (stream[j + 3] >> 1) & 0x3F
        units.append((t, start, end))
        i = j + 3
    ps = b"".join(stream[s:e] for (t, s, e) in units if t in (32, 33, 34))
    gops = []
    cur = bytearray()
    for (t, s, e) in units:
        if t in (32, 33, 34):
            continue
        if is_vcl(t) and (is_idr(t) or is_bla(t) or is_cra(t)):
            if cur:
                gops.append(bytes(cur))
            cur = bytearray()
        cur += stream[s:e]
    if cur:
        gops.append(bytes(cur))
    return [ps + g for g in gops]


def _counters():
    from ..ops.kernels.intra_scan import intra_scan
    from ..ops.kernels.mc_filter import mc_predict
    from ..ops.kernels.mc_tables import build_tile_tables, update_tile_table
    from ..ops.kernels.sao_filter import sao_ctb
    return (update_tile_table, mc_predict, sao_ctb, intra_scan,
            build_tile_tables)


def _decode_gop(args):
    """Worker: decode segment `seg` on `device`. Returns (idx, [(poc,
    yuv_bytes)], stats): stats hold the frame routes, the launches of
    K1-K5 in this call, its wall seconds and its start and end on the
    host's clock (time.time(): the parent reads the workers' start-up
    and the results' transfer from them)."""
    start = time.time()
    idx, seg, native, device = args
    from .. import api
    counters = _counters()
    for f in counters:
        f.launches = 0
    st = {}
    t0 = time.perf_counter()
    if native:
        pics = api.decode_stream_native(seg, device=device, stats=st)
    else:
        pics = api.decode_stream(seg, device=device, stats=st)
    stats = {k: st.get(k, 0) for k in ("n_frames", "n_host_frames",
                                       "n_hybrid_frames")}
    frames = [(p.poc, p.to_yuv_bytes()) for p in pics]
    stats.update(device=device, wall_s=time.perf_counter() - t0,
                 launches=[f.launches for f in counters], start=start,
                 end=time.time())
    return idx, frames, stats


def decode_gop_parallel(stream: bytes, workers=None, native=True,
                        backend=None, devices=None, stats=None, pool=None):
    """Decode the GOPs of `stream`; returns (poc, yuv_bytes) frames in
    presentation order per GOP.

    backend None or "device": decode_gop_device first; only where it
    refuses the stream (ValueError / AssertionError) do the workers take
    it. backend "workers": the workers at once. Any other exception
    propagates: nothing is decoded another way.

    devices: the device list, default ["cuda"]; the device route takes
    one GOP per entry, worker segment i decodes on devices[i %
    len(devices)]. workers: processes (default: one per segment, at most
    the host's CPU count). native=False decodes each segment through the
    push API (api.decode_stream) instead of decode_stream_native.
    pool: a spawn-context multiprocessing pool to run the workers on,
    left open; None starts one for the call. Spawned workers import the
    caller's main module, so a calling script keeps its work under
    `if __name__ == "__main__":`.

    stats: optional dict, filled with route ("device" or "workers"),
    n_gops, n_frames, n_host_frames, n_hybrid_frames and, for the
    workers, launches (K1-K5 summed over them) and per_gop (each
    segment's stats: device, frame routes, launches, wall_s, start,
    end)."""
    if backend not in (None, "device", "workers"):
        raise ValueError(
            f"backend {backend!r}: use 'device' or 'workers' (the JAX "
            f"package's 'numpy' route is 'workers' here: the port's "
            f"workers decode on their devices)")
    devices = list(devices) if devices is not None else ["cuda"]
    if not devices:
        raise ValueError("decode_gop_parallel: empty device list")
    for d in devices:
        resolve(d)
    st = stats if stats is not None else {}
    if backend in (None, "device"):
        try:
            frames = decode_gop_device(stream, devices, stats=st)
            st["route"] = "device"
            return frames
        except (AssertionError, ValueError):
            pass          # a stream the GOP decoder refuses: workers
    from .. import _build
    _build.ensure_frontend()
    if any(resolve(d).type == "cuda" for d in devices):
        _build.kernels_lib()      # workers load the cached library
    gops = split_gops(stream)
    tasks = [(i, g, native, str(devices[i % len(devices)]))
             for i, g in enumerate(gops or [stream])]
    if len(tasks) == 1:
        results = [_decode_gop(tasks[0])]
    elif pool is not None:
        results = pool.map(_decode_gop, tasks)
    else:
        n = workers or min(len(tasks), mp.cpu_count())
        with mp.get_context("spawn").Pool(n) as p:
            results = p.map(_decode_gop, tasks)
    results.sort(key=lambda r: r[0])
    out = [f for _, frames, _ in results for f in frames]
    per = [s for _, _, s in results]
    st.update(route="workers", n_gops=len(tasks),
              n_frames=sum(s["n_frames"] for s in per),
              n_host_frames=sum(s["n_host_frames"] for s in per),
              n_hybrid_frames=sum(s["n_hybrid_frames"] for s in per),
              launches=[sum(c) for c in zip(*(s["launches"] for s in per))],
              per_gop=per)
    return out


def decode_gop_device(stream: bytes, devices=None, stats=None):
    """Native parse + the GOP-sharded decoder over `devices` (default
    ["cuda"]; the list may repeat a device). Returns (poc, yuv_bytes)
    GOP by GOP, by POC within a GOP, conformance-cropped. Raises
    ValueError for a stream whose GOPs it cannot decode alone."""
    from ..api import _parse
    from .gop_shard import decode_gops
    plans = _parse(stream)
    pics, st = decode_gops(plans, plans[0].sps if plans else None,
                           devices if devices is not None else ["cuda"])
    if stats is not None:
        stats.update(st)
    return [(p.poc, p.to_yuv_bytes()) for p in pics]
