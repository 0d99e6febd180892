"""Host and device time of one 4K P frame through the frame program, for
comparing two checkouts of the port on one CUDA card.

    python3 libde265_tpu_torch/time_frames.py [ROOT] [TAG]

ROOT is the checkout whose libde265_tpu_torch is timed (default: the one
holding this file); the script is run by path so that ROOT's package is
the one imported. It decodes the first P frame of tests/data/ld4k_light
through profile_frames.frame_calls, then three times: CUDA-event
milliseconds per frame over 20 frames, the host's enqueue milliseconds
per frame over 20 frames (no synchronisation inside) and the median of
10 frames each synchronised. Lines are tagged with TAG.

    python3 libde265_tpu_torch/time_frames.py --k4 [ROOT] [TAG]

times ROOT's K4 wrapper `intra_scan` on the whole ld4k_light IDR instead,
each plane group on seeded random planes: CUDA-event milliseconds per
call over 10 calls, three times, and a digest of the planes after one
call (equal digests: the two checkouts computed the same planes).

    python3 libde265_tpu_torch/time_frames.py --k2 [ROOT] [TAG]

times ROOT's K2 wrapper `mc_predict` the same way: on the first
ld4k_light P frame's real grids over seeded 8-slot 4K tables (luma, then
the [Cb|Cr] pair), and on ROOT's chip_smoke.k2_synthetic bi + weighted
4K case over the same tables.

    python3 libde265_tpu_torch/time_frames.py --k1 [ROOT] [TAG]

times ROOT's K1 wrapper `update_tile_table` on a seeded 4K frame into
slot 5 of an 8-slot table (luma, then chroma), and K5's
`build_tile_tables` (both launches) on seeded stacks of R = 2 1080p
frames (the tile path's shape) and R = 8 4K frames into uint8 tables.

    python3 libde265_tpu_torch/time_frames.py --k3 [ROOT] [TAG]

times ROOT's whole SAO stage of the first ld4k_light P frame (its real
grids, as frame_grids leaves them, over seeded random 4K planes): the
three K3 wrapper calls `sao_ctb` where ROOT has them, else ROOT's
planner `plan_sao_compact` and the compact-map wrapper `sao_filter`
for each plane, as ROOT's frame program runs them; then each plane's
share alone, beside the copy floor of that plane (one torch clone: the
bytes K3 must move). Equal digests: the two checkouts computed the same
planes.
"""
import hashlib
import os
import sys
import time


def time_k4(plans, dev, tag):
    from dataclasses import replace

    import numpy as np
    import torch
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    from libde265_tpu_torch.profile_frames import cuda_ms
    cfg = replace(stream_cfg(plans, plans[0].sps), skip_mc=True)
    t = plan_from_numpy(pack_frame(plans[0], cfg, {}), dev)
    rng = np.random.RandomState(2160)
    dims = [(cfg.H, cfg.W)] + [(cfg.H // 2, cfg.W // 2)] * 2
    for idx, kw in scan_groups(t, cfg):
        got = [torch.as_tensor(rng.randint(0, 256, dims[i]),
                               dtype=torch.int32, device=dev) for i in idx]
        intra_scan(got, **kw)
        digest = _digest(got)
        for rep in range(3):
            ms = cuda_ms(lambda: intra_scan(got, **kw), 10)
            print(f"{tag} K4 planes {idx} rep {rep}: {ms:.4f} ms a call; "
                  f"planes sha256 {digest}", flush=True)


def _digest(ts):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in ts)).hexdigest()[:16]


def graph_ms(fn, reps):
    """(device milliseconds a call, outputs): `reps` calls of fn()
    captured in one CUDA graph after a warm-up call, the second replay
    timed with CUDA events, so the host's enqueue of each call is not in
    the window; the outputs are fn()'s return values, holding what the
    timed replay computed. (Here, not in profile_frames: the timed
    checkout may predate it.)"""
    import torch
    from libde265_tpu_torch.profile_frames import cuda_ms
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for _ in range(reps):
            outs.append(fn())
    g.replay()
    return cuda_ms(g.replay, 1) / reps, outs


def _report(tag, what, fn, outs):
    """Three CUDA-event windows of 10 calls of fn, each beside the device
    time of the same 10 calls replayed from a CUDA graph (no host enqueue
    in the window), with the digest of the outputs `outs` after the first
    call."""
    from libde265_tpu_torch.profile_frames import cuda_ms
    digest = _digest(outs)
    for rep in range(3):
        ms = cuda_ms(fn, 10)
        gms = graph_ms(fn, 10)[0]
        print(f"{tag} {what} rep {rep}: {ms:.4f} ms a call (graph replay "
              f"{gms:.4f}); outputs sha256 {digest}", flush=True)


def time_k2(plans, dev, tag):
    from dataclasses import replace

    import numpy as np
    from chip_smoke import k2_synthetic
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids, mc_inputs
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    t = pack_frame(plans[1], cfg, {plans[0].frame_id: 3,
                                   plans[1].frame_id: 5})
    grids = mc_inputs(frame_grids(plan_from_numpy(t, dev), cfg), cfg)
    tables, synth = k2_synthetic(np.random.RandomState(2160), cfg.H, cfg.W,
                                 8, dev)
    for name, a, bi in (("P frame", grids, cfg.has_bi),
                        ("bi + weighted", synth, True)):
        for tab in tables:
            args = (tab, (cfg.H, cfg.W), *a, 8, bi)
            grp = "luma" if tab.shape[1] == 256 else "Cb|Cr"
            _report(tag, f"K2 4K {name} {grp}", lambda: mc_predict(*args),
                    mc_predict(*args))


def time_k1(dev, tag):
    import torch
    from libde265_tpu_torch.ops.kernels.mc_tables import (build_tile_tables,
                                                          update_tile_table)
    from libde265_tpu_torch.ops.mc_tile import pad_plane, pad_refs
    from libde265_tpu_torch.packing import (PAD_C, PAD_Y, REF_SLOTS,
                                            n_tiles_c, n_tiles_y)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2160)

    def planes(*shape):
        return torch.randint(0, 256, shape, dtype=torch.int16, device=dev,
                             generator=gen)
    H, W = 2160, 3840
    for T, P, (h, w), pad, (nty, ntx) in (
            (16, 1, (H, W), PAD_Y, n_tiles_y(H, W)),
            (8, 2, (H // 2, W // 2), PAD_C, n_tiles_c(H // 2, W // 2))):
        padded = pad_plane(planes(P, h, w), pad).contiguous()
        table = torch.zeros((REF_SLOTS * nty * ntx, P * T * T),
                            dtype=torch.uint8, device=dev)
        update_tile_table(table, padded, 5, T)
        _report(tag, f"K1 4K {'luma' if T == 16 else 'chroma'} slot",
                lambda: update_tile_table(table, padded, 5, T), [table])
        del table
    for R, (h, w) in ((2, (1080, 1920)), (8, (H, W))):
        py, pc = pad_refs(planes(R, h, w), planes(R, h // 2, w // 2),
                          planes(R, h // 2, w // 2))
        _report(tag, f"K5 {w}x{h} R={R} uint8 (2 launches)",
                lambda: build_tile_tables(py, pc, torch.uint8),
                build_tile_tables(py, pc, torch.uint8))
        del py, pc
        torch.cuda.empty_cache()


def time_k3(plans, dev, tag):
    from dataclasses import replace

    import numpy as np
    import torch
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids
    from libde265_tpu_torch.ops.kernels import sao_filter as k
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    g = frame_grids(plan_from_numpy(pack_frame(
        plans[1], cfg, {plans[0].frame_id: 3, plans[1].frame_id: 5}), dev),
        cfg)
    rng = np.random.RandomState(2160)
    planes = [torch.as_tensor(rng.randint(0, 256, s), dtype=torch.int32,
                              device=dev)
              for s in [(cfg.H, cfg.W)] + [(cfg.H // 2, cfg.W // 2)] * 2]
    if hasattr(k, "sao_ctb"):
        what = "K3 from the CTB parameters (sao_ctb)"

        def plane(ci):
            return k.sao_ctb(planes[ci], g, cfg.scfg, ci, bitdepth=8)
    else:
        from libde265_tpu_torch.ops.filter_plan import plan_sao_compact
        what = "planner + K3 (plan_sao_compact + sao_filter)"

        def plane(ci):
            mode, aux, offs = plan_sao_compact(g, cfg.scfg, ci)
            return k.sao_filter(planes[ci], mode.contiguous(),
                                aux.contiguous(), offs.contiguous(),
                                bitdepth=8)

    def stage():
        return [plane(ci) for ci in range(3)]
    _report(tag, f"SAO stage of a 4K P frame, {what} x 3", stage, stage())
    for ci in range(3):
        _report(tag, f"SAO plane {ci} of a 4K P frame, {what}",
                lambda: plane(ci), [plane(ci)])
        # the copy floor: one PyTorch clone of the plane reads and writes
        # the same bytes as K3 (the port never calls it)
        _report(tag, f"copy yardstick, plane {ci} (torch clone)",
                lambda: planes[ci].clone(), [planes[ci]])


def main(argv):
    mode = argv[0] if argv[:1] and argv[0] in ("--k1", "--k2", "--k3",
                                               "--k4") else None
    argv = argv[1:] if mode else argv
    root = os.path.abspath(argv[0]) if argv else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = argv[1] if len(argv) > 1 else root
    sys.path.insert(0, root)
    import torch
    from libde265_tpu_torch import _build
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.profile_frames import cuda_ms, frame_calls
    dev = torch.device("cuda")
    _build.ensure_frontend()
    with open(os.path.join(root, "tests", "data", "ld4k_light.bin"),
              "rb") as f:
        plans = _parse(f.read())
    if mode == "--k4":
        return time_k4(plans, dev, tag)
    if mode == "--k2":
        return time_k2(plans, dev, tag)
    if mode == "--k1":
        return time_k1(dev, tag)
    if mode == "--k3":
        return time_k3(plans, dev, tag)
    (_, idr, _), (_, pframe, _) = frame_calls(plans, dev)
    idr()
    pframe()
    torch.cuda.synchronize()
    for rep in range(3):
        ev = cuda_ms(pframe, 20)
        t0 = time.perf_counter()
        for _ in range(20):
            pframe()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        synced = []
        for _ in range(10):
            a = time.perf_counter()
            pframe()
            torch.cuda.synchronize()
            synced.append(time.perf_counter() - a)
        print(f"{tag} rep {rep}: events {ev:.3f} ms/frame; host enqueue "
              f"{1e3 * (t1 - t0) / 20:.3f} ms/frame; synchronised median "
              f"{1e3 * sorted(synced)[5]:.3f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
