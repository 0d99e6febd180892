"""Device-resident stream decoder (PyTorch).

Counterpart of libde265_tpu/device_stream.py:DeviceStreamDecoder. Owns
the DPB stacks and MC tile tables on the device and routes every frame
through the frame program (frame_program.decode_frame_device). A frame
the program cannot take (frame_compatible refuses it) goes, as in the
JAX decoder, to the numpy reference (reconstruct.py) when it uses a tool
only that implements (frame_uses_rext_tools: cross-component prediction,
implicit RDPCM, rotation, disabled smoothing; counted in
`n_host_frames`), and otherwise to the hybrid device path
(device_decode.reconstruct_frame_device: TU-level chroma QP offsets,
explicit RDPCM; counted in `n_hybrid_frames`) on the decoder's device.
Either way the frame lands in the device DPB. Pixels are downloaded only
when a consumer asks (output, or a host frame referencing a device one).

The JAX version runs a run of frames as one lax.scan dispatch; here the
scan is a Python loop over the same uploaded per-dtype blobs.
decode_all_pipelined packs on a builder thread ahead of the device and
uploads from page-locked buffers on a copy stream of its own.

ShardedStreamDecoder is the tile-column variant: one tile column per
entry of a device list (parallel/tile_shard.py). PictureStreamDecoder is
the per-picture variant, fed one plan at a time by the push decoder's
Python front end (decoder.PictureDecoder) through bridge_plan.
"""
import copy
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from . import telemetry
from .convert import plan_from_numpy, to_tensor
from .device import resolve
from .device_decode import reconstruct_frame_device
from .frame_program import (check_slice, decode_frame_device, init_tables,
                            unpack_blob, update_tables)
from .packing import (REF_SLOTS, blob_meta, frame_compatible,
                      frame_has_intra, frame_has_mc, frame_uses_rext_tools,
                      pack_blob, pack_blob_native, pack_frame, stream_cfg)
from .parallel.tile_shard import decode_frame_tiles, split_strips
from .plan import (MODE_INTRA, PU_FID0, PU_H, PU_PF0, PU_W, PU_X, PU_Y,
                   TU_CIDX, TU_IMODE, TU_LOG2, TU_PM, TU_X, TU_Y,
                   grey_planes, pu_table, tu_table)
from .reconstruct import reconstruct_frame

# what host work raises on a corrupted plan (bridge_plan's checks, the
# packers' asserts, table lookups)
DATA_ERRORS = (ValueError, AssertionError, IndexError, KeyError)


def filter_switches():
    """(deblocking off, SAO off): the debug kill-switches
    DE265_DISABLE_DEBLOCK and DE265_DISABLE_SAO (dec265
    --disable-deblocking / --disable-sao), read as reconstruct.py reads
    them."""
    return tuple(os.environ.get(k, "0") != "0"
                 for k in ("DE265_DISABLE_DEBLOCK", "DE265_DISABLE_SAO"))


def switch_filters(plan, off):
    """`plan`, or, where a switch of `off` (filter_switches) is set, a
    view of it whose slice headers turn that filter off in every slice:
    slice_deblocking_filter_disabled_flag set, slice_sao_luma_flag and
    slice_sao_chroma_flag cleared. Every device route reads the filters
    from those flags (device_plan.slice_tables: sh_disable, sh_sao_luma,
    sh_sao_chroma; ops/filters_fused.py's gates), and with them so set
    the numpy reference skips the filter as its switch does. The view
    shares everything else with the plan."""
    deblock_off, sao_off = off
    if not (deblock_off or sao_off) or not plan.slice_headers:
        return plan
    shs = []
    for sh in plan.slice_headers:
        sh = copy.copy(sh)
        if deblock_off:
            sh.slice_deblocking_filter_disabled_flag = 1
        if sao_off:
            sh.slice_sao_luma_flag = sh.slice_sao_chroma_flag = 0
        shs.append(sh)
    v = copy.copy(plan)
    v.slice_headers = shs
    if plan._pu_arrays is not None:
        v._pu_arrays = (plan._pu_arrays[0], shs)
    return v


class HostDataError(ValueError):
    """A data error of a frame's host work (stream_cfg, packing, the numpy
    reference of a frame_uses_rext_tools frame), raised before that
    frame's own launches. An error of a launch or of a kernel's wrapper
    is never one: a caller may hand the stream to another path on this
    error alone."""


def _host(fn, *args):
    """fn(*args) with its DATA_ERRORS raised as HostDataError."""
    try:
        return fn(*args)
    except HostDataError:
        raise
    except DATA_ERRORS as e:
        raise HostDataError(f"{fn.__name__}: {e!r}") from e


class _HostRefShim:
    """Maps frame ids to host planes for the numpy reconstruction."""

    class _P:
        __slots__ = ("planes", "plan", "poc")

    def __init__(self, dec):
        self.dec = dec

    @property
    def pics(self):
        return self

    def __getitem__(self, fid):
        p = self._P.__new__(self._P)
        f = self.dec.frames[fid]
        p.planes = self.dec._host_planes(fid)
        p.plan = f["plan"]
        p.poc = f["plan"].poc
        return p


class DeviceStreamDecoder:
    """Decode a parsed plan list with a device-resident DPB on `device`
    ("cuda" unless the caller asks for "cpu"). The filter kill-switches
    (filter_switches) are read once, here, and apply to every frame it
    decodes (switch_filters); with SAO switched off K3 is not
    launched.

    Spans: stream_setup (this constructor, with stream_cfg: the scan of
    every plan for the program's caps), pack (n: frames; their seconds
    add up to pack_seconds), upload (n: bytes), download (n: bytes), and
    the frame program's and the hybrid path's own."""

    def __init__(self, plans, sps, device="cuda"):
        with telemetry.span("stream_setup"):
            self._setup(plans, sps, device)

    def _setup(self, plans, sps, device):
        self.device = resolve(device)
        self.filters_off = filter_switches()
        plans = [switch_filters(p, self.filters_off) for p in plans]
        self.plans = plans
        with telemetry.span("stream_cfg", len(plans)):
            self.cfg = _host(stream_cfg, plans, sps)
        check_slice(self.cfg)
        H, W = self.cfg.H, self.cfg.W
        self.Hc, self.Wc = self.cfg.chroma_dims
        z16 = dict(dtype=torch.int16, device=self.device)
        self.dy = torch.zeros((REF_SLOTS, H, W), **z16)
        self.dcb = torch.zeros((REF_SLOTS, self.Hc, self.Wc), **z16)
        self.dcr = torch.zeros((REF_SLOTS, self.Hc, self.Wc), **z16)
        self.ty, self.tc = init_tables(self.cfg, self.device)
        self.slot_of = {}              # fid -> slot
        self.slot_fid = [None] * REF_SLOTS
        self.frames = {}               # fid -> {plan, host(np)|None, fast}
        self.last_use = self._last_uses(plans)
        self._set_cfg(self.cfg)
        self.dtype = np.uint8 if self.cfg.bitdepth == 8 else np.uint16
        self.n_host_frames = 0         # frames reconstructed by numpy
        self.n_hybrid_frames = 0       # frames of the hybrid device path
        self.pack_seconds = 0.0        # seconds of this decoder's pack spans
        self.n_pipelined_frames = 0    # frames decode_all_pipelined ran

    def _set_cfg(self, cfg):
        """The program variants that share one state: the scan cfg (no
        intra stage) for inter frames; the full cfg for intra-containing
        frames; a skip_mc flavour for zero-PU frames (I-frames). With
        SAO switched off (filter_switches) no variant runs K3."""
        if self.filters_off[1]:
            cfg = replace(cfg, sao_enabled=False)
        self.cfg = cfg
        self.cfg_scan = replace(cfg, intra=(), intra_C=0)
        self._cfgs = {(False, True): self.cfg_scan}
        if cfg.intra:
            self._cfgs[(True, True)] = cfg
            self._cfgs[(True, False)] = replace(cfg, skip_mc=True)

    def state(self):
        return [self.dy, self.dcb, self.dcr, self.ty, self.tc]

    def _last_uses(self, plans):
        last = {}
        for i, plan in enumerate(plans):
            # an output frame's pixels are needed until downloaded: keep it
            # host-copied on eviction
            if plan.nal_type != -1 and getattr(plan, "output_flag", True):
                last[plan.frame_id] = len(plans)
            for fid in self.ref_fids(plan):
                last[fid] = max(last.get(fid, -1), i)
        return last

    # ------------------------------------------------------------ slots
    @staticmethod
    def _next_slot(slot_fid, needed, last_use):
        """(slot, fid it evicts or None) for the next frame, given the
        slots' contents: the first free slot, else the eviction victim
        (fids the frame does not reference first, then the earliest last
        use)."""
        free = [s for s, f in enumerate(slot_fid) if f is None]
        if free:
            return free[0], None
        s = min(range(REF_SLOTS),
                key=lambda s: (slot_fid[s] in needed,
                               last_use.get(slot_fid[s], -1)))
        return s, slot_fid[s]

    def _alloc_slot(self, fid, frame_idx, needed):
        s, vfid = self._next_slot(self.slot_fid, needed, self.last_use)
        if vfid is not None:
            if self.last_use.get(vfid, -1) >= frame_idx:
                # still needed later: keep a host copy before eviction
                self._host_planes(vfid)
            del self.slot_of[vfid]
        self.slot_of[fid] = s
        self.slot_fid[s] = fid
        return s

    def _do_insert(self, planes, slot):
        """Planes (host numpy, or tensors on the device) into the DPB
        stacks and tile tables at `slot` (monochrome: luma only; the
        chroma dummies stay as they are)."""
        def dev16(p):
            return p.to(torch.int16) if torch.is_tensor(p) \
                else to_tensor(p.astype(np.int16), self.device)
        Y = dev16(planes[0])
        Cb = Cr = None
        self.dy[slot] = Y
        if not self.cfg.mono:
            Cb, Cr = (dev16(p) for p in planes[1:])
            self.dcb[slot] = Cb
            self.dcr[slot] = Cr
        update_tables(self.ty, self.tc, Y, Cb, Cr, slot, self.cfg)

    def _ensure_in_stack(self, fid, frame_idx, needed):
        if fid in self.slot_of:
            return self.slot_of[fid]
        planes = self._host_planes(fid)
        s = self._alloc_slot(fid, frame_idx, needed)
        self._do_insert(planes, s)
        return s

    def _host_planes(self, fid):
        f = self.frames[fid]
        if f["host"] is None:
            s = self.slot_of[fid]
            with telemetry.span("download") as sp:
                f["host"] = [p[s].cpu().numpy().astype(self.dtype) for p in
                             ((self.dy,) if self.cfg.mono
                              else (self.dy, self.dcb, self.dcr))]
                sp.n = sum(p.nbytes for p in f["host"])
            if self.cfg.mono:                 # no chroma planes: (0, 0)
                f["host"] += [np.zeros((0, 0), self.dtype)] * 2
        return f["host"]

    # ----------------------------------------------------------- decode
    @staticmethod
    def ref_fids(plan):
        pm = plan._pu_arrays[0] if plan._pu_arrays is not None else None
        if pm is None or not pm.shape[0]:
            return set()
        out = set()
        for l in range(2):
            out |= set(int(v) for v in np.unique(pm[pm[:, 4 + l] > 0,
                                                    14 + l]))
        return out

    def decode_plan(self, plan, frame_idx):
        """Decode one frame and register it in the device DPB."""
        plan = switch_filters(plan, self.filters_off)
        fid = plan.frame_id
        needed = self.ref_fids(plan)
        if plan.nal_type == -1:           # concealment: grey frame
            planes = grey_planes(plan.sps, self.cfg.W, self.cfg.H)
            self.frames[fid] = {"plan": plan, "host": planes, "fast": False}
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)
            return
        if frame_uses_rext_tools(plan):
            # (never a frame the program takes) the numpy reference
            # reconstructs every tool; the frame still lands in the
            # device DPB
            planes = _host(reconstruct_frame, plan, _HostRefShim(self))
            self.n_host_frames += 1
            self.frames[fid] = {"plan": plan, "host": planes, "fast": False}
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)
            return
        for rf in needed:
            self._ensure_in_stack(rf, frame_idx, needed)
        s = self._alloc_slot(fid, frame_idx, needed)
        if frame_compatible(plan) and self._fast_ok(plan):
            self._run_fast(plan, s)
            self.frames[fid] = {"plan": plan, "host": None, "fast": True}
        else:
            reconstruct_frame_device(plan, self, s)
            self.n_hybrid_frames += 1
            self.frames[fid] = {"plan": plan, "host": None, "fast": False}

    def _fast_ok(self, plan):
        return not (frame_has_intra(plan) and not self.cfg.intra)

    def _pack(self, plan, cfg, fid_slot):
        with telemetry.span("pack", 1) as sp:
            t = _host(pack_frame, plan, cfg, fid_slot)
        self.pack_seconds += sp.seconds
        return t

    def _run_fast(self, plan, out_slot):
        key = (frame_has_intra(plan), frame_has_mc(plan))
        cfg = self._cfgs.get(key) or self._cfgs[(False, True)]
        t = plan_from_numpy(self._pack(plan, cfg, self.slot_of), self.device)
        decode_frame_device(*self.state(), t, out_slot, cfg)

    def decode_all(self):
        """Decode the whole plan list; maximal runs of consecutive
        device frames upload as one blob per dtype and decode in one
        loop (_run_fast_scan)."""
        i, n = 0, len(self.plans)
        while i < n:
            run = self._collect_fast_run(i)
            if len(run) >= 2:
                self._run_fast_scan(run)
                i += len(run)
            else:
                self.decode_plan(self.plans[i], i)
                i += 1

    def _collect_fast_run(self, i0):
        """Simulate slot allocation forward from plan i0; returns
        [(plan, frame_idx, out_slot, packed_tensors), ...] for the maximal
        batchable run. Stops at a frame that needs the host path, a ref
        upload from the host, or an eviction that needs a host copy."""
        sim_of = dict(self.slot_of)
        sim_fid = list(self.slot_fid)
        run = []
        for i in range(i0, len(self.plans)):
            plan = self.plans[i]
            # a subclass (ShardedStreamDecoder) decodes every frame
            # through its own _run_fast: nothing batches past it
            if plan.nal_type == -1 or not frame_compatible(plan) \
                    or frame_has_intra(plan) or not self._fast_ok(plan) \
                    or type(self) is not DeviceStreamDecoder:
                break                  # intra frames: singleton decode
            needed = self.ref_fids(plan)
            if any(rf not in sim_of for rf in needed):
                break                      # ref needs a host upload
            s, vfid = self._next_slot(sim_fid, needed, self.last_use)
            if vfid is not None:
                if vfid in needed or self.last_use.get(vfid, -1) >= i:
                    break                  # eviction needs a host copy
                del sim_of[vfid]
            sim_of[plan.frame_id] = s
            sim_fid[s] = plan.frame_id
            run.append((plan, i, s, self._pack(plan, self.cfg_scan, sim_of)))
        return run

    def _run_fast_scan(self, run):
        # the run's frames were packed (and counted) one by one
        with telemetry.span("pack") as sp:
            stacked = {k: np.stack([t[k] for (_, _, _, t) in run])
                       for k in run[0][3]}
            meta, totals = blob_meta(stacked)
            bufs = pack_blob(stacked, meta, totals)
        self.pack_seconds += sp.seconds
        with telemetry.span("upload",
                            sum(v.nbytes for v in bufs.values())):
            ts = unpack_blob({k: to_tensor(v, self.device)
                              for k, v in bufs.items()}, meta)
        self._decode_batch(ts, [(plan, s) for plan, _, s, _ in run],
                           self.cfg_scan)

    def _decode_batch(self, ts, plan_slots, cfg):
        """Run the frame program over the frames of one unpacked blob
        (`ts`, stacked along the first axis), frame j into slot
        plan_slots[j][1], with _alloc_slot's bookkeeping for the slots
        chosen ahead."""
        for j, (plan, s) in enumerate(plan_slots):
            decode_frame_device(*self.state(),
                                {k: v[j] for k, v in ts.items()}, s, cfg)
            fid = plan.frame_id
            vfid = self.slot_fid[s]
            if vfid is not None and vfid in self.slot_of:
                del self.slot_of[vfid]
            self.slot_of[fid] = s
            self.slot_fid[s] = fid
            self.frames[fid] = {"plan": plan, "host": None, "fast": True}

    def planes_of(self, fid):
        return self._host_planes(fid)

    # ------------------------------------------------- pipelined decode
    def schedule_slots(self, keep_outputs=False):
        """Precompute (plan, frame_idx, out_slot) for every frame of a
        stream that runs wholly on the frame program. Slot choices depend
        only on plan metadata, never on device results, so the whole
        schedule is known before the first dispatch: this is what lets
        packing run ahead of the device. keep_outputs=False is throughput
        mode: output pictures are not pinned in the DPB until download.
        Raises PipelineUnsupported when a frame needs the host path or a
        host pixel copy, or the decoder is the tile-column one (which
        decodes frame by frame)."""
        if type(self) is not DeviceStreamDecoder:
            raise PipelineUnsupported("the tile-column decoder decodes "
                                      "frame by frame")
        last_use = self.last_use if keep_outputs else \
            self._last_uses_refs_only()
        sim_of, sim_fid = dict(self.slot_of), list(self.slot_fid)
        out = []
        for i, plan in enumerate(self.plans):
            if plan.nal_type == -1 or not frame_compatible(plan) \
                    or not self._fast_ok(plan):
                raise PipelineUnsupported(f"frame {i}: host path")
            needed = self.ref_fids(plan)
            if any(rf not in sim_of for rf in needed):
                raise PipelineUnsupported(f"frame {i}: ref not resident")
            s, vfid = self._next_slot(sim_fid, needed, last_use)
            if vfid is not None:
                if vfid in needed or last_use.get(vfid, -1) >= i:
                    raise PipelineUnsupported(
                        f"frame {i}: would evict needed frame {vfid}")
                del sim_of[vfid]
            sim_of[plan.frame_id] = s
            sim_fid[s] = plan.frame_id
            out.append((plan, i, s))
        return out

    def _last_uses_refs_only(self):
        """last_use from reference dependencies only: output pictures
        are not pinned until download (throughput mode: the consumer
        drains them, as dec265 -q discards its output)."""
        last = {}
        for i, plan in enumerate(self.plans):
            for fid in self.ref_fids(plan):
                last[fid] = max(last.get(fid, -1), i)
        return last

    def decode_all_pipelined(self, batch=8, pack_workers=2,
                             keep_outputs=True):
        """decode_all with packing running ahead of the device. The slot
        schedule is precomputed (schedule_slots); a builder thread packs
        batches of up to `batch` consecutive frames of one kind (intra or
        not, MC or not) on a pool of `pack_workers` threads into staging
        buffers (_StagingRing: page-locked on a CUDA device); the calling
        thread only uploads each blob (asynchronously, on a copy stream)
        and runs the frame program over its frames. The first batch of
        each (kind, length) packs with numpy, which fixes the blob layout;
        later ones with the C++ packer (packing.pack_blob_native), or
        numpy again where it refuses the layout (intra, PCM, scaling
        lists). An exception on the builder thread is raised here. A
        stream that schedule_slots refuses runs decode_all. With a filter
        kill-switch set it raises ValueError: the C++ packer reads the
        slice headers its own parse kept, not the plan's."""
        if any(self.filters_off):
            raise ValueError("decode_all_pipelined: the filter kill-switches "
                             "(DE265_DISABLE_DEBLOCK / DE265_DISABLE_SAO) "
                             "are set; use decode_all")
        try:
            sched = self.schedule_slots(keep_outputs=keep_outputs)
        except PipelineUnsupported:
            return self.decode_all()
        # batches of consecutive same-kind frames: each kind has its
        # program variant (intra stage or not, MC or not)
        groups = []
        for item in sched:
            plan = item[0]
            kind = (frame_has_intra(plan), frame_has_mc(plan))
            if groups and groups[-1][0] == kind \
                    and len(groups[-1][1]) < batch:
                groups[-1][1].append(item)
            else:
                groups.append((kind, [item]))
        kinds = dict(self._cfgs)
        kinds[(False, False)] = replace(self.cfg_scan, skip_mc=True)
        slot_map = dict(self.slot_of)
        slot_map.update((plan.frame_id, s) for plan, _, s in sched)
        ring = _StagingRing(self.device)
        done = queue.Queue()
        stop = threading.Event()

        def builder():
            err = None
            try:
                self._build_blobs(groups, kinds, slot_map, pack_workers,
                                  ring, done, stop)
            except Exception as e:          # raised in the caller
                err = e
            finally:
                done.put(err)

        th = threading.Thread(target=builder, name="pack-builder",
                              daemon=True)
        th.start()
        try:
            while True:
                got = done.get()
                if got is None:
                    break
                if isinstance(got, Exception):
                    raise got
                cfg, meta, idx, views, items = got
                self._decode_batch(unpack_blob(ring.upload(idx, views),
                                               meta),
                                   [(plan, s) for plan, _, s in items], cfg)
                self.n_pipelined_frames += len(items)
        finally:
            stop.set()
            ring.close()
            th.join()

    def _build_blobs(self, groups, kinds, slot_map, pack_workers, ring,
                     done, stop):
        """Builder thread of decode_all_pipelined: pack each batch into a
        staging set and queue (cfg, meta, set index, views, items). Only
        this thread calls pack_blob_native (its layout is state on the
        one front-end handle)."""
        meta_cache = {}
        with ThreadPoolExecutor(max_workers=pack_workers) as ex:
            for kind, items in groups:
                if stop.is_set():
                    return
                cfg = kinds[kind]
                plans = [it[0] for it in items]
                key = (kind, len(items))
                if key in meta_cache:
                    meta, totals = meta_cache[key]
                    got = ring.acquire(totals)
                    if got is None:
                        return
                    with telemetry.span("pack", len(plans)) as sp:
                        packed = pack_blob_native(
                            plans, cfg, slot_map, meta, totals,
                            out={dt: v.numpy() for dt, v in got[1].items()})
                    self.pack_seconds += sp.seconds
                    if packed is not None:
                        done.put((cfg, meta, *got, items))
                        continue
                    ring.release(got[0])
                with telemetry.span("pack", len(plans)) as sp:
                    frames = list(ex.map(
                        lambda p: pack_frame(p, cfg, slot_map), plans))
                    stacked = {k: np.stack([t[k] for t in frames])
                               for k in frames[0]}
                    meta, totals = blob_meta(stacked)
                meta_cache[key] = (meta, totals)
                self.pack_seconds += sp.seconds
                got = ring.acquire(totals)
                if got is None:
                    return
                # the same frames again: n counts them once
                with telemetry.span("pack") as sp:
                    pack_blob(stacked, meta, totals,
                              out={dt: v.numpy() for dt, v in got[1].items()})
                self.pack_seconds += sp.seconds
                done.put((cfg, meta, *got, items))


class PipelineUnsupported(Exception):
    """The stream needs the host path or host pixel copies: use
    decode_all."""


class _StagingRing:
    """Host staging of decode_all_pipelined: `n` sets of per-dtype blob
    buffers that the builder thread packs into, and their upload. On a
    CUDA device the buffers are page-locked and each upload is an
    asynchronous copy on a stream of its own, which the compute stream
    waits for; a set goes back to the builder only once the event
    recorded behind its upload has completed. A failure to pin or to
    create the stream raises. On the CPU the upload is a plain copy."""

    def __init__(self, device, n=4):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.sets = [{} for _ in range(n)]
        self.free = queue.Queue()
        for i in range(n):
            self.free.put((i, None))

    def acquire(self, totals):
        """(index, {dtype: 1-D tensor view}) of a free set sized for
        `totals` (blob_meta), once its last upload has left it; None
        after close()."""
        i, ev = self.free.get()
        if i is None:
            return None
        if ev is not None:
            ev.synchronize()
        views = {}
        for dt, n in totals.items():
            a = self.sets[i].get(dt)
            if a is None or a.numel() < n:
                ndt = np.dtype(dt)
                if ndt.kind == "b":
                    ndt = np.dtype(np.uint8)     # pack_blob's bool layout
                a = self.sets[i][dt] = torch.empty(
                    n, dtype=torch.from_numpy(np.empty(0, ndt)).dtype,
                    pin_memory=self.cuda)
            views[dt] = a[:n]
        return i, views

    def release(self, i):
        self.free.put((i, None))

    def upload(self, i, views):
        """Device copies of set i's views (ready for the compute stream's
        later work); set i goes back to the builder."""
        if not self.cuda:
            out = {dt: v.clone() for dt, v in views.items()}
            self.release(i)
            return out
        compute = torch.cuda.current_stream(self.device)
        with telemetry.span("upload", sum(v.nbytes for v in views.values())), \
                torch.cuda.stream(self.stream):
            out = {dt: v.to(self.device, non_blocking=True)
                   for dt, v in views.items()}
            ev = torch.cuda.Event()
            ev.record(self.stream)
        compute.wait_event(ev)
        for a in out.values():
            # allocated on the copy stream, read on the compute stream:
            # the caching allocator must not reuse them before that
            a.record_stream(compute)
        self.free.put((i, ev))
        return out

    def close(self):
        """Wake a builder waiting in acquire()."""
        self.free.put((None, None))


class ShardedStreamDecoder(DeviceStreamDecoder):
    """Tile-column decoder: every pure-inter frame of a tile-encoded
    stream decodes as one strip per tile column, strip d on devices[d]
    (parallel/tile_shard.py). `devices` has one entry per tile column and
    may repeat a device; each distinct device holds a replica of the DPB
    stacks. Frames with intra CUs run the single-device frame program on
    devices[0], and their result is copied to the other replicas. After
    every strip frame, K1 brings the persistent MC tile tables (on
    devices[0]) up to date from the reassembled slot. Asking
    for CUDA where there is none raises, and so does a stream whose
    frames are not len(devices) tile columns of 4:2:0 samples (ValueError):
    no inter frame of a stream it accepts leaves the strip program."""

    def __init__(self, plans, sps, devices):
        devs = [resolve(d) for d in devices]
        if not devs:
            raise ValueError("ShardedStreamDecoder: empty device list")
        for plan in plans:
            if plan.nal_type != -1:
                self._check_geometry(plan, len(devs))
        super().__init__(plans, sps, devs[0])
        self.devices = devs
        self.ndev = len(devs)
        self.replicas = {self.device: (self.dy, self.dcb, self.dcr)}
        for d in devs[1:]:
            if d not in self.replicas:
                self.replicas[d] = tuple(
                    torch.zeros(a.shape, dtype=a.dtype, device=d)
                    for a in (self.dy, self.dcb, self.dcr))
        self.n_strip_frames = 0        # frames decoded as strips

    @staticmethod
    def _check_geometry(plan, ndev):
        """Every frame must split into exactly ndev tile columns of 4:2:0
        samples; otherwise its inter frames would have no strip program,
        so the decoder refuses the stream rather than decoding them on
        the host. Non-uniform columns pad to the widest (pps.h:109-151)."""
        pps = plan.pps
        if not getattr(pps, "tiles_enabled_flag", False):
            raise ValueError("ShardedStreamDecoder: the stream has no tiles")
        if plan.sps.ChromaArrayType != 1:
            raise ValueError("ShardedStreamDecoder: strips need 4:2:0 "
                             f"chroma, the stream has ChromaArrayType "
                             f"{plan.sps.ChromaArrayType}")
        if pps.num_tile_columns != ndev:
            raise ValueError(f"ShardedStreamDecoder: {ndev} devices for "
                             f"{pps.num_tile_columns} tile columns (one "
                             f"device per column)")

    def _replicate(self, slot):
        """Copy DPB slot `slot` from devices[0]'s stacks to the other
        replicas."""
        src = (self.dy, self.dcb, self.dcr)
        for dev, planes in self.replicas.items():
            if dev != self.device:
                for dst, a in zip(planes, src):
                    dst[slot] = a[slot].to(dev)

    def _do_insert(self, planes, slot):
        super()._do_insert(planes, slot)
        self._replicate(slot)

    def _run_fast(self, plan, out_slot):
        if frame_has_intra(plan):
            super()._run_fast(plan, out_slot)
            self._replicate(out_slot)
            return
        with telemetry.span("pack", 1) as sp:
            tsh, trep, x0w = split_strips(plan, self.cfg_scan, self.slot_of,
                                          self.ndev)
        self.pack_seconds += sp.seconds
        decode_frame_tiles(self.replicas, self.devices, tsh, trep, x0w,
                           out_slot, self.cfg_scan)
        # the strips write only the DPB: bring the persistent MC tables
        # up to date for a later frame of the single-device program
        update_tables(self.ty, self.tc, self.dy[out_slot],
                      self.dcb[out_slot], self.dcr[out_slot], out_slot,
                      self.cfg)
        self.n_strip_frames += 1


def bridge_plan(plan, frame_id, nal_type, output_flag, fid_of):
    """A view of a plan that the Python front end parsed (bitstream/
    ctu.py's SliceReader) in the native front end's layout: _tu_arrays /
    _pu_arrays from tu_table / pu_table, with PU_FID0/1 the frame ids of
    the references (fid_of: Python DPB index -> frame id; a list a PU
    does not use keeps -1), and the fields the device decoder reads
    (frame_id; nal_type, -1 for a grey stand-in; output_flag;
    max_num_reorder). The view shares the plan's grids; the plan keeps
    its TU / PU records, which the numpy reference reads. Raises
    ValueError where a coefficient does not fit the int16 pool
    (tu_table) or a value the device would index with lies outside the
    picture (check_view)."""
    v = copy.copy(plan)
    v.frame_id, v.nal_type, v.output_flag = frame_id, nal_type, \
        int(output_flag)
    v.max_num_reorder = plan.sps.max_num_reorder_pics[-1]
    if nal_type == -1:
        v._tu_arrays = (np.zeros((0, 12), np.int32), np.zeros(1, np.int16),
                        np.zeros(1, np.int16))
        v._pu_arrays = (np.zeros((0, 17), np.int32), v.slice_headers)
        return v
    tm, cpool, ppool = tu_table(plan)
    # a PCM row's intra mode is 0 in the native layout (-1 in the record)
    tm[tm[:, TU_CIDX] == -1, TU_IMODE] = 0
    v._tu_arrays = (tm, cpool, ppool)
    pm = pu_table(plan).copy()
    for l in range(2):
        used = pm[:, PU_PF0 + l] > 0
        pm[used, PU_FID0 + l] = [fid_of.get(int(i), -1)
                                 for i in pm[used, PU_FID0 + l]]
    v._pu_arrays = (pm, v.slice_headers)
    check_view(v)
    return v


def check_view(v):
    """ValueError unless every TU and PU of the bridged view lies inside
    its plane, every TU is 4x4 to 32x32 of a known plane, every intra
    mode is one of the 35 and every used reference has a frame id: the
    values the device program indexes with (an index outside its tensor
    is a device fault on the card, not an exception)."""
    tm = v._tu_arrays[0]
    sps = v.sps
    if tm.shape[0]:
        cidx, log2 = tm[:, TU_CIDX], tm[:, TU_LOG2]
        if ((cidx < -1) | (cidx > (2 if sps.ChromaArrayType else 0))
                | (log2 < 2) | (log2 > 5)).any():
            raise ValueError("TU of an unknown plane or size")
        n = 1 << log2
        sub = np.where(cidx > 0, 1, 0)
        W = np.where(sub, v.W // sps.SubWidthC, v.W)
        H = np.where(sub, v.H // sps.SubHeightC, v.H)
        if ((tm[:, TU_X] < 0) | (tm[:, TU_Y] < 0) | (tm[:, TU_X] + n > W)
                | (tm[:, TU_Y] + n > H)).any():
            raise ValueError("TU outside its plane")
        intra = (tm[:, TU_PM] == MODE_INTRA) & (cidx >= 0)
        im = tm[intra, TU_IMODE]
        if ((im < 0) | (im > 34)).any():
            raise ValueError("intra mode outside 0..34")
    pm = v._pu_arrays[0]
    if pm.shape[0]:
        if ((pm[:, PU_X] < 0) | (pm[:, PU_Y] < 0) | (pm[:, PU_W] < 4)
                | (pm[:, PU_H] < 4) | (pm[:, PU_X] + pm[:, PU_W] > v.W)
                | (pm[:, PU_Y] + pm[:, PU_H] > v.H)).any():
            raise ValueError("PU outside the picture")
        for l in range(2):
            if (pm[pm[:, PU_PF0 + l] > 0, PU_FID0 + l] < 0).any():
                raise ValueError("PU references a DPB entry without a "
                                 "picture")


class PictureStreamDecoder(DeviceStreamDecoder):
    """The device decoder fed one picture at a time, in decode order (the
    push decoder's Python front end, decoder.PictureDecoder). The state
    (DPB stacks, tile tables) is shaped by the SPS alone (size, bit depth,
    chroma format); each frame runs with a ProgramCfg of its own caps
    (stream_cfg over that frame), since no cap may come from a frame not
    yet parsed. A picture is decoded in two steps: prepare does all its
    host work (checks, caps, slot moves, packing) and may refuse it with a
    DATA_ERRORS exception before anything reaches the device; launch then
    runs the frame program or the hybrid path, and nothing it raises is a
    refusal. A frame leaves the device DPB when the caller's DPB no
    longer uses it (retain); while all REF_SLOTS hold live frames, the
    one the frame being decoded does not reference, non-references first
    and then the oldest, is evicted with a host copy kept."""

    def __init__(self, sps, device="cuda"):
        super().__init__([], sps, device)
        self.geometry = stream_geometry(sps)
        self.rank = {}                 # fid -> eviction order key

    def retain(self, rank):
        """Keep the frames of `rank` (fid -> eviction key: lower goes
        first), drop every other frame with its slot."""
        for fid in [f for f in self.frames if f not in rank]:
            del self.frames[fid]
            s = self.slot_of.pop(fid, None)
            if s is not None:
                self.slot_fid[s] = None
        self.rank = rank

    def _pick_slot(self, slot_fid, needed):
        """The slot for the next frame: a free one, else the one whose
        frame goes first (not in `needed`, then by rank)."""
        free = [s for s, f in enumerate(slot_fid) if f is None]
        if free:
            return free[0]
        s = min(range(REF_SLOTS), key=lambda s: (
            slot_fid[s] in needed, self.rank.get(slot_fid[s], ())))
        if slot_fid[s] in needed:
            raise ValueError(f"a frame references more than {REF_SLOTS} "
                             f"frames")
        return s

    def _alloc_slot(self, fid, frame_idx, needed):
        s = self._pick_slot(self.slot_fid, needed)
        vfid = self.slot_fid[s]
        if vfid is not None:
            self._host_planes(vfid)        # live: keep a host copy
            del self.slot_of[vfid]
        self.slot_of[fid] = s
        self.slot_fid[s] = fid
        return s

    def prepare(self, view):
        """The host work of one bridged coded picture (bridge_plan): its
        checks, its ProgramCfg, the slot moves (each reference held only
        on the host, then the frame itself: (frame id, slot, evicted
        frame id or None)) and, for the frame program, its packed
        tensors. Reads no device memory and launches nothing; a
        DATA_ERRORS exception refuses the picture (the caller then
        reconstructs it on the host and puts it in with insert_host).
        Returns the job for launch."""
        view = switch_filters(view, self.filters_off)
        if stream_geometry(view.sps) != self.geometry:
            raise ValueError("SPS geometry differs from the decoder's")
        needed = self.ref_fids(view)
        if any(f not in self.frames for f in needed):
            raise KeyError(f"frame {view.frame_id} references a frame "
                           f"the device DPB does not hold")
        cfg = stream_cfg([view], view.sps)
        try:
            check_slice(cfg)
        except NotImplementedError as e:
            raise ValueError(str(e)) from e
        self._set_cfg(cfg)
        slot_of, slot_fid = dict(self.slot_of), list(self.slot_fid)
        moves = []
        for fid in [*(f for f in needed if f not in slot_of), view.frame_id]:
            s = self._pick_slot(slot_fid, needed)
            vfid = slot_fid[s]
            if vfid is not None:
                del slot_of[vfid]
            slot_of[fid], slot_fid[s] = s, fid
            moves.append((fid, s, vfid))
        packed = None
        if frame_compatible(view) and self._fast_ok(view):
            key = (frame_has_intra(view), frame_has_mc(view))
            pcfg = self._cfgs.get(key) or self._cfgs[(False, True)]
            packed = (pcfg, self._pack(view, pcfg, slot_of))
        return view, moves, packed

    def launch(self, job):
        """The device work of a prepared picture: the slot moves (a host
        copy of each evicted frame, each host-held reference uploaded
        with K1), then the frame program (K1-K4) or the hybrid path into
        the frame's slot. What it raises is an error, never a
        refusal."""
        view, moves, packed = job
        for fid, s, vfid in moves:
            if vfid is not None:
                self._host_planes(vfid)
                del self.slot_of[vfid]
            self.slot_of[fid], self.slot_fid[s] = s, fid
            if fid != view.frame_id:
                self._do_insert(self.frames[fid]["host"], s)
        out_slot = moves[-1][1]
        if packed is not None:
            cfg, t = packed
            decode_frame_device(*self.state(),
                                plan_from_numpy(t, self.device), out_slot,
                                cfg)
        else:
            reconstruct_frame_device(view, self, out_slot)
            self.n_hybrid_frames += 1
        self.frames[view.frame_id] = {"plan": view, "host": None,
                                      "fast": packed is not None}

    def insert_host(self, view, planes):
        """Host planes (the numpy reference's, or grey concealment) as
        the frame `view`."""
        self.frames[view.frame_id] = {"plan": view, "host": planes,
                                      "fast": False}
        s = self._alloc_slot(view.frame_id, 0, self.ref_fids(view))
        self._do_insert(planes, s)


def stream_geometry(sps):
    """What shapes PictureStreamDecoder's state: size, bit depths,
    chroma format."""
    return (sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
            sps.BitDepthY, sps.BitDepthC, sps.ChromaArrayType)
