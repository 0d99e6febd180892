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

ShardedStreamDecoder is the tile-column variant: one tile column per
entry of a device list (parallel/tile_shard.py).
"""
import time
from dataclasses import replace

import numpy as np
import torch

from .convert import plan_from_numpy, to_tensor
from .device import resolve
from .frame_program import (check_slice, decode_frame_device, init_tables,
                            unpack_blob, update_tables)
from .packing import (REF_SLOTS, blob_meta, frame_compatible,
                      frame_has_intra, frame_has_mc, pack_blob, pack_frame,
                      stream_cfg)
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
        self.dtype = np.uint8
        self.n_host_frames = 0         # frames reconstructed by numpy
        self.pack_seconds = 0.0        # host clock spent packing plans

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
    def _alloc_slot(self, fid, frame_idx, needed):
        free = [s for s, f in enumerate(self.slot_fid) if f is None]
        if not free:
            # evict: prefer fids no longer referenced, then oldest
            cands = sorted(
                range(REF_SLOTS),
                key=lambda s: (self.slot_fid[s] in needed,
                               self.last_use.get(self.slot_fid[s], -1)))
            victim = cands[0]
            vfid = self.slot_fid[victim]
            if self.last_use.get(vfid, -1) >= frame_idx:
                # still needed later: keep a host copy before eviction
                self._host_planes(vfid)
            del self.slot_of[vfid]
            self.slot_fid[victim] = None
            free = [victim]
        s = free[0]
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
            free = [s for s, f in enumerate(sim_fid) if f is None]
            if free:
                s = free[0]
            else:
                cands = sorted(
                    range(REF_SLOTS),
                    key=lambda s: (sim_fid[s] in needed,
                                   self.last_use.get(sim_fid[s], -1)))
                s = cands[0]
                vfid = sim_fid[s]
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
        for j, (plan, _, s, _) in enumerate(run):
            t = {k: v[j] for k, v in ts.items()}
            decode_frame_device(*self.state(), t, s, self.cfg_scan)
            # mirror _alloc_slot bookkeeping for the simulated choices
            fid = plan.frame_id
            vfid = self.slot_fid[s]
            if vfid is not None and vfid in self.slot_of:
                del self.slot_of[vfid]
            self.slot_of[fid] = s
            self.slot_fid[s] = fid
            self.frames[fid] = {"plan": plan, "host": None, "fast": True}

    def planes_of(self, fid):
        return self._host_planes(fid)

    def decode_all_pipelined(self, *args, **kwargs):
        raise NotImplementedError(
            "libde265_tpu_torch does not port decode_all_pipelined (host "
            "packing overlapped with the device, "
            "libde265_tpu/device_stream.py:389); use decode_all")


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
