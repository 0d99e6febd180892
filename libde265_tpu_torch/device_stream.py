"""Device-resident stream decoder (PyTorch).

Counterpart of libde265_tpu/device_stream.py:DeviceStreamDecoder. Owns
the DPB stacks and MC tile tables on the device and routes every frame
through the frame program (frame_program.decode_frame_device). Frames
the program cannot take (frame_compatible rejects them: range-extension
residual tools, TU-level chroma QP offsets) are reconstructed by the
numpy reference (reconstruct.py) and inserted into the device
DPB; they are counted in `n_host_frames`. Pixels are downloaded only
when a consumer asks (output, or a host frame referencing a device one).

The JAX version runs a run of frames as one lax.scan dispatch; here the
scan is a Python loop over the same uploaded per-dtype blobs.
decode_all_pipelined packs on a builder thread ahead of the device and
uploads from page-locked buffers on a copy stream of its own.

ShardedStreamDecoder is the tile-column variant: one tile column per
entry of a device list (parallel/tile_shard.py).
"""
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from .convert import plan_from_numpy, to_tensor
from .device import resolve
from .frame_program import (check_slice, decode_frame_device, init_tables,
                            unpack_blob, update_tables)
from .packing import (REF_SLOTS, blob_meta, frame_compatible,
                      frame_has_intra, frame_has_mc, pack_blob,
                      pack_blob_native, pack_frame, stream_cfg)
from .parallel.tile_shard import decode_frame_tiles, split_strips
from .plan import grey_planes
from .reconstruct import reconstruct_frame


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
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, plans, sps, device="cuda"):
        self.device = resolve(device)
        self.plans = plans
        self.cfg = stream_cfg(plans, sps)
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
        # program variants sharing one state: the scan cfg (no intra
        # stage) for inter frames; the full cfg for intra-containing
        # frames; a skip_mc flavour for zero-PU frames (I-frames)
        self.cfg_scan = replace(self.cfg, intra=(), intra_C=0)
        self._cfgs = {(False, True): self.cfg_scan}
        if self.cfg.intra:
            self._cfgs[(True, True)] = self.cfg
            self._cfgs[(True, False)] = replace(self.cfg, skip_mc=True)
        self.dtype = np.uint8 if self.cfg.bitdepth == 8 else np.uint16
        self.n_host_frames = 0         # frames reconstructed by numpy
        self.pack_seconds = 0.0        # host clock spent packing plans
        self.n_pipelined_frames = 0    # frames decode_all_pipelined ran

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
        Y, Cb, Cr = (to_tensor(p.astype(np.int16), self.device)
                     for p in planes)
        self.dy[slot] = Y
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
            f["host"] = [p[s].cpu().numpy().astype(self.dtype)
                         for p in (self.dy, self.dcb, self.dcr)]
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
        fid = plan.frame_id
        needed = self.ref_fids(plan)
        if plan.nal_type == -1:           # concealment: grey frame
            planes = grey_planes(plan.sps, self.cfg.W, self.cfg.H)
            self.frames[fid] = {"plan": plan, "host": planes, "fast": False}
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)
            return
        if frame_compatible(plan) and self._fast_ok(plan):
            for rf in needed:
                self._ensure_in_stack(rf, frame_idx, needed)
            s = self._alloc_slot(fid, frame_idx, needed)
            self._run_fast(plan, s)
            self.frames[fid] = {"plan": plan, "host": None, "fast": True}
        else:
            # the numpy reference reconstructs every tool; the frame still
            # lands in the device DPB
            planes = reconstruct_frame(plan, dpb_images=_HostRefShim(self))
            self.n_host_frames += 1
            self.frames[fid] = {"plan": plan, "host": planes, "fast": False}
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)

    def _fast_ok(self, plan):
        return not (frame_has_intra(plan) and not self.cfg.intra)

    def _pack(self, plan, cfg, fid_slot):
        t0 = time.perf_counter()
        t = pack_frame(plan, cfg, fid_slot)
        self.pack_seconds += time.perf_counter() - t0
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
        t0 = time.perf_counter()
        stacked = {k: np.stack([t[k] for (_, _, _, t) in run])
                   for k in run[0][3]}
        meta, totals = blob_meta(stacked)
        bufs = pack_blob(stacked, meta, totals)
        self.pack_seconds += time.perf_counter() - t0
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
        stream that schedule_slots refuses runs decode_all."""
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
                    t0 = time.perf_counter()
                    packed = pack_blob_native(
                        plans, cfg, slot_map, meta, totals,
                        out={dt: v.numpy() for dt, v in got[1].items()})
                    self.pack_seconds += time.perf_counter() - t0
                    if packed is not None:
                        done.put((cfg, meta, *got, items))
                        continue
                    ring.release(got[0])
                t0 = time.perf_counter()
                frames = list(ex.map(
                    lambda p: pack_frame(p, cfg, slot_map), plans))
                stacked = {k: np.stack([t[k] for t in frames])
                           for k in frames[0]}
                meta, totals = blob_meta(stacked)
                meta_cache[key] = (meta, totals)
                self.pack_seconds += time.perf_counter() - t0
                got = ring.acquire(totals)
                if got is None:
                    return
                t0 = time.perf_counter()
                pack_blob(stacked, meta, totals,
                          out={dt: v.numpy() for dt, v in got[1].items()})
                self.pack_seconds += time.perf_counter() - t0
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
        with torch.cuda.stream(self.stream):
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
        t0 = time.perf_counter()
        tsh, trep, x0w = split_strips(plan, self.cfg_scan, self.slot_of,
                                      self.ndev)
        self.pack_seconds += time.perf_counter() - t0
        decode_frame_tiles(self.replicas, self.devices, tsh, trep, x0w,
                           out_slot, self.cfg_scan)
        # the strips write only the DPB: bring the persistent MC tables
        # up to date for a later frame of the single-device program
        update_tables(self.ty, self.tc, self.dy[out_slot],
                      self.dcb[out_slot], self.dcr[out_slot], out_slot,
                      self.cfg)
        self.n_strip_frames += 1
