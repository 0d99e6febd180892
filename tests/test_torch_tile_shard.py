"""The port's tile-column decoder (libde265_tpu_torch/parallel/tile_shard.py
and device_stream.ShardedStreamDecoder, CPU tensors: the kernels' plain
versions) against the JAX package's (libde265_tpu/parallel/tile_shard.py
on the virtual CPU mesh of tests/conftest.py) and the dec265 MD5s: the
per-frame table build (K5's plain version against the Pallas builder in
interpret mode and the XLA builder), MC in strip form (K2's plain
version against the Pallas tap kernel), the strip-local filter planners,
the host strip split, and whole streams."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
TILE_STREAMS = [("p_tiles2_mv", 2), ("p_tiles2_mv_nolf", 2),
                ("p_tiles3r_mv", 3), ("p_tiles4_mv", 4), ("p_tiles8_mv", 8),
                ("p_tiles8nu_mv", 8)]


def _plans(name):
    from libde265_tpu_torch.api import _parse
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return _parse(f.read())


def _scan_cfgs(plans):
    import dataclasses
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import packing as P
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    return (dataclasses.replace(cj, intra=(), intra_C=0),
            dataclasses.replace(cp, intra=(), intra_C=0))


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_build_tile_tables_matches_jax(bitdepth):
    """K5's plain version (the wrapper on CPU tensors) against the JAX
    build_tables(use_pallas=True) path, run with the Pallas builder in
    interpret mode (valid rows: the Pallas pad rows hold roll residue),
    and against the XLA builder on whole tables. R = 3, 72x136."""
    import jax.numpy as jnp
    from libde265_tpu.ops import mc_tile_jax as M
    from libde265_tpu.ops.pallas.mc_tables import build_tile_table_pallas
    from libde265_tpu_torch.ops.kernels.mc_tables import build_tile_tables
    from libde265_tpu_torch.ops.mc_tile import build_tables
    rng = np.random.RandomState(bitdepth)
    R, H, W = 3, 72, 136
    maxv = (1 << bitdepth) - 1
    refs = [rng.randint(0, maxv + 1, (R, h, w)).astype(np.int16)
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    n = build_tile_tables.launches
    got = [t.numpy() for t in build_tables(*(torch.as_tensor(r)
                                             for r in refs), bitdepth)]
    assert build_tile_tables.launches == n
    dt = jnp.uint8 if bitdepth == 8 else jnp.int16
    assert got[0].dtype == np.dtype(dt)
    xla = [np.asarray(t) for t in M.build_tables(
        *(jnp.asarray(r) for r in refs), use_pallas=False,
        bitdepth=bitdepth)]
    # build_tables(use_pallas=True) with the Pallas builder interpreted
    py, pcb, pcr = M._pad_refs(*(jnp.asarray(r) for r in refs))
    tcb, tcr = (np.asarray(build_tile_table_pallas(p, 8, out_dtype=dt,
                                                   interpret=True))
                for p in (pcb, pcr))
    pal = [np.asarray(build_tile_table_pallas(py, 16, out_dtype=dt,
                                              interpret=True)),
           np.concatenate([tcb, tcr], axis=1)]
    for g, x, p, (nty, ntx), hw in zip(
            got, xla, pal, (M.n_tiles_y(H, W), M.n_tiles_c(H // 2, W // 2)),
            ((H, W), (H // 2, W // 2))):
        assert g.shape == x.shape == p.shape and g.dtype == x.dtype
        assert np.array_equal(g, x)
        nv = (hw[0] + (20 if hw == (H, W) else 12)) // 4
        gv = g.reshape(R, nty, ntx, -1)[:, :nv]
        assert np.array_equal(gv, p.reshape(R, nty, ntx, -1)[:, :nv])


def _strip_case(seed, H, W, Ws, bi, weighted):
    rng = np.random.RandomState(seed)
    R = 3
    refs = [rng.randint(0, 256, (R, h, w)).astype(np.int32)
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    N = (H // 4) * (Ws // 4)
    mv = rng.randint(-(1 << 14), 1 << 14, (N, 2, 2)).astype(np.int32)
    near = rng.rand(N) < 0.6
    mv[near] = rng.randint(-64, 64, (int(near.sum()), 2, 2))
    slot = rng.randint(0, R, (N, 2)).astype(np.int32)
    pf = np.stack([np.ones(N, np.int32),
                   rng.randint(0, 2, N).astype(np.int32) * bi], axis=1)
    wts = np.zeros((N, 3, 5), np.int32)
    ex = np.zeros(N, bool)
    if weighted:
        ex[:] = rng.rand(N) < 0.7
        wts[:, :, 4] = rng.randint(0, 8, (N, 3)) + 6
        wts[:, :, 0] = rng.randint(-128, 128, (N, 3))
        wts[:, :, 2] = rng.randint(-128, 128, (N, 3))
        wts[:, :, 1] = rng.randint(-127, 127, (N, 3))
        wts[:, :, 3] = rng.randint(-127, 127, (N, 3))
    inter = rng.rand(H // 4, Ws // 4) < 0.85
    return refs, mv, slot, pf, wts, ex, inter


@pytest.mark.parametrize("x0,Ws,bi,weighted", [
    (0, 128, False, False),          # first strip
    (128, 128, True, False),         # x0 > 0
    (192, 128, True, True),          # short strip: dead right padding
    (64, 64, False, True),
])
def test_mc_predict_strip_matches_jax(x0, Ws, bi, weighted):
    """K2's plain version in strip form against the JAX
    mc_frame_tile(strip=Ws, x0=x0, use_pallas=True) (the Pallas tap
    kernel in interpret mode), masked with the same inter mask, exact.
    The reference frames are 64x256; the strip at x0 = 192 runs past the
    frame's right edge."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import build_tables, mc_frame_tile
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    H, W = 64, 256
    refs, mv, slot, pf, wts, ex, inter = _strip_case(x0 + Ws, H, W, Ws, bi,
                                                     weighted)
    tabs = build_tables(*(jnp.asarray(r) for r in refs), bitdepth=8)
    want = mc_frame_tile(tabs, (H, W), *(jnp.asarray(a) for a in
                                         (mv, slot, pf, wts, ex)), 8,
                         strip=Ws, x0=x0, bi=bi, use_pallas=True,
                         weighted=weighted)
    w = (torch.as_tensor(wts), torch.as_tensor(ex.astype(np.int32))) \
        if weighted else (None, None)
    args = ((H, W), torch.as_tensor(mv), torch.as_tensor(slot),
            torch.as_tensor(pf), *w, torch.as_tensor(inter), 8, bi)
    ty, tc = (torch.as_tensor(np.asarray(t)) for t in tabs)
    got = mc_predict_plain(ty, *args, strip=Ws, x0=x0) + \
        mc_predict_plain(tc, *args, strip=Ws, x0=x0)
    for ci, (g, j) in enumerate(zip(got, want)):
        f = 4 if ci == 0 else 2
        j = np.asarray(j) * np.kron(inter, np.ones((f, f), bool))
        assert g.shape == j.shape, ci
        assert np.array_equal(g.numpy(), j), ci


@pytest.mark.parametrize("name,ndev", [("p_tiles3r_mv", 3),
                                       ("p_tiles8nu_mv", 8)])
def test_split_strips_byte_identical(name, ndev):
    """The host half: the port's split_strips (through its
    pack_frame(real_slots=False)) equals the JAX package's on every P
    frame, byte for byte."""
    from libde265_tpu.parallel import tile_shard as J
    from libde265_tpu_torch.packing import frame_has_intra
    from libde265_tpu_torch.parallel import tile_shard as T
    plans = _plans(name)
    cj, cp = _scan_cfgs(plans)
    fid_slot = {p.frame_id: i for i, p in enumerate(plans)}
    n = 0
    for plan in plans:
        if frame_has_intra(plan):
            continue
        assert J.strip_geometry(plan, ndev) == T.strip_geometry(plan, ndev)
        a, b = J.split_strips(plan, cj, fid_slot, ndev), \
            T.split_strips(plan, cp, fid_slot, ndev)
        for da, db in zip(a[:2], b[:2]):
            assert sorted(da) == sorted(db)
            for k in da:
                assert da[k].dtype == db[k].dtype and \
                    da[k].tobytes() == db[k].tobytes(), (name, k)
        assert np.array_equal(a[2], b[2])
        n += 1
    assert n >= 2


def test_filter_planners_xoff_match_jax():
    """plan_deblock_device and plan_sao_compact with a strip's xoff
    (x0 - 16) against the JAX planners on every strip of p_tiles3r_mv's
    first P frame, exact; xoff = 0 keeps the whole-frame form."""
    import jax.numpy as jnp
    from libde265_tpu.ops import filter_plan_jax as J
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.ops import filter_plan as F
    from libde265_tpu_torch.parallel import tile_shard as T
    plans = _plans("p_tiles3r_mv")
    _, cp = _scan_cfgs(plans)
    fid_slot = {p.frame_id: i for i, p in enumerate(plans)}
    tsh, trep, x0w = T.split_strips(plans[1], cp, fid_slot, 3)

    def same(a, b, what):
        if isinstance(a, (tuple, list)):
            assert len(a) == len(b), what
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, (what, i))
            return
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), what

    for d in range(3):
        t = dict(trep, **{k: v[d] for k, v in tsh.items()})
        tj = {k: jnp.asarray(v) for k, v in t.items()}
        tp = plan_from_numpy(t, "cpu")
        xoff = int(x0w[d, 0]) - T.HALO_Y
        same(F.plan_deblock_device(tp, cp.fcfg, xoff),
             J.plan_deblock_device(tj, cp.fcfg, xoff=xoff), ("dbk", d))
        for ci in range(3):
            same(F.plan_sao_compact(tp, cp.scfg, ci, xoff),
                 J.plan_sao_compact(tj, cp.scfg, ci, xoff=xoff),
                 ("sao", d, ci))


@pytest.mark.parametrize("x0", [0, 64, 448])
def test_expand_ctb4_strip_matches_jax(x0):
    """The strip-local CTB -> 4x4 expansion that the weighted strip path
    uses for its slice-table rows (no committed tile vector is weighted),
    against the JAX package's, halo and clip included."""
    import jax.numpy as jnp
    from libde265_tpu.parallel import tile_shard as J
    from libde265_tpu_torch.parallel import tile_shard as T
    _, cp = _scan_cfgs(_plans("p_tiles8nu_mv"))
    nctby, nctbx = -(-cp.H >> cp.log2ctb), -(-cp.W >> cp.log2ctb)
    a = np.arange(nctby * nctbx, dtype=np.int32).reshape(nctby, nctbx)
    ws4h = 128 // 4 + 2 * T.GB
    got = T._expand_ctb4_strip(torch.as_tensor(a), cp, ws4h, x0)
    want = J._expand_ctb4_strip(jnp.asarray(a), cp, ws4h, x0)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _md5s(planes):
    return [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
            for p in planes]


@pytest.mark.parametrize("name,ndev", TILE_STREAMS)
def test_sharded_decoder_md5(name, ndev):
    """ShardedStreamDecoder(devices=["cpu"] * ncols) through decode_all:
    every frame MD5-equal to manifest_inter.json, at most the IDR off the
    device program, and every pure-inter frame decoded as strips."""
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    from libde265_tpu_torch.packing import frame_has_intra
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        m = json.load(f)[name]
    plans = _plans(name)
    dec = ShardedStreamDecoder(plans, plans[0].sps, ["cpu"] * ndev)
    dec.decode_all()
    n_fast = sum(dec.frames[p.frame_id]["fast"] for p in plans)
    assert n_fast >= len(plans) - 1 and dec.n_host_frames == 0
    n_inter = sum(not frame_has_intra(p) for p in plans)
    assert n_inter >= len(plans) - 1
    assert dec.n_strip_frames == n_inter
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    assert len(outs) == m["frames"]
    for i, plan in enumerate(outs):
        assert _md5s(dec.planes_of(plan.frame_id)) == \
            [m["md5"][i][k] for k in ("y", "u", "v")], (name, i)


def test_decode_all_takes_strips_for_every_inter_frame():
    """decode_all of a ShardedStreamDecoder batches nothing through the
    replicated program: _collect_fast_run stops at once, so each P frame
    reaches the strip program (the entry point counts it)."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    plans = _plans("p_tiles2_mv")
    dec = ShardedStreamDecoder(plans, plans[0].sps, ["cpu", "cpu"])
    dec.decode_plan(plans[0], 0)
    assert dec._collect_fast_run(1) == []
    with open(os.path.join(DATA, "p_tiles2_mv.bin"), "rb") as f:
        st = {}
        pics = decode_stream_native(f.read(), stats=st,
                                    tile_devices=["cpu", "cpu"])
    assert (len(pics), st["n_strip_frames"], st["n_host_frames"]) == \
        (4, 3, 0)


@pytest.mark.parametrize("name,ndev", [("p_tiles3r_mv", 3),
                                       ("p_tiles8nu_mv", 8)])
def test_final_state_matches_jax_sharded(name, ndev):
    """Same plans through the JAX ShardedStreamDecoder on the virtual
    CPU mesh and the port's: identical DPB stacks and slot assignment,
    sample for sample. The JAX strip program leaves the persistent tile
    tables stale for the frames it decodes (ROADMAP queue 3); the port's
    hold what the JAX single-device decoder keeps, every slot's tables
    built from its DPB frame, so they are held against the JAX
    update_tables applied to each slot of the JAX DPB."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from libde265_tpu import frame_program as J
    from libde265_tpu.device_stream import ShardedStreamDecoder as JaxDec
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    from libde265_tpu_torch.packing import REF_SLOTS
    plans = _plans(name)
    jd = JaxDec(plans, plans[0].sps,
                Mesh(np.array(jax.devices()[:ndev]), ("t",)))
    for i, plan in enumerate(plans):
        jd.decode_plan(plan, i)
    pd = ShardedStreamDecoder(plans, plans[0].sps, ["cpu"] * ndev)
    pd.decode_all()
    assert pd.slot_of == jd.slot_of
    for what, a, b in zip(("dy", "dcb", "dcr"), pd.state(),
                          (jd.dy, jd.dcb, jd.dcr)):
        assert np.array_equal(a.numpy(), np.asarray(b)), what
    ty, tc = J.init_tables(jd.cfg)
    for s in range(REF_SLOTS):
        ty, tc = J.update_tables(ty, tc, *(jnp.asarray(p[s]) for p in
                                           (jd.dy, jd.dcb, jd.dcr)),
                                 np.int32(s), jd.cfg)
    for what, a, b in (("ty", pd.ty, ty), ("tc", pd.tc, tc)):
        assert np.array_equal(a.numpy(), np.asarray(b)), what


def test_strip_frames_refresh_tile_tables():
    """After every strip frame, the persistent MC tile tables at the
    frame's slot equal update_tables applied to that slot's DPB planes in
    fresh tables, as the single-device decoder leaves them: a later frame
    with intra CUs runs the single-device program and predicts from
    them."""
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    from libde265_tpu_torch.frame_program import init_tables, update_tables
    from libde265_tpu_torch.packing import REF_SLOTS
    plans = _plans("p_tiles2_mv")
    dec = ShardedStreamDecoder(plans, plans[0].sps, ["cpu", "cpu"])
    n = 0
    for i, plan in enumerate(plans):
        ns = dec.n_strip_frames
        dec.decode_plan(plan, i)
        if dec.n_strip_frames == ns:
            continue
        s = dec.slot_of[plan.frame_id]
        ty, tc = init_tables(dec.cfg, "cpu")
        update_tables(ty, tc, dec.dy[s], dec.dcb[s], dec.dcr[s], s, dec.cfg)
        for what, got, want in (("ty", dec.ty, ty), ("tc", dec.tc, tc)):
            r = want.shape[0] // REF_SLOTS
            assert torch.equal(got[s * r:(s + 1) * r],
                               want[s * r:(s + 1) * r]), (what, i, s)
        n += 1
    assert n == len(plans) - 1


def test_sharded_cuda_request_raises_without_a_card():
    """A CUDA device list where there is no card raises; there is no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    plans = _plans("p_tiles2_mv")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedStreamDecoder(plans, plans[0].sps, ["cuda:0", "cuda:0"])


@pytest.mark.parametrize("name,ndev,why", [
    ("p_tiles4_mv", 3, "tile columns"),
    ("p_tiles4_mv", 5, "tile columns"),
    ("b_mv", 2, "no tiles"),
])
def test_sharded_decoder_refuses_mismatched_geometry(name, ndev, why):
    """A device list that does not give one device to each tile column
    of a 4:2:0 stream is refused (ValueError), through the class and the
    entry point: its inter frames would otherwise leave the strip
    program for the host."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    plans = _plans(name)
    with pytest.raises(ValueError, match=why):
        ShardedStreamDecoder(plans, plans[0].sps, ["cpu"] * ndev)
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match=why):
        decode_stream_native(data, tile_devices=["cpu"] * ndev)


def test_sharded_decoder_partial_widest_last_column():
    """416x64 with 64-pixel CTBs in two uniform columns: 3 and 4 CTBs,
    the last column both the widest and partial (224 valid of 256), so
    the strip width (whole CTBs) exceeds every valid width. Encoded here
    by the JAX package's encoder; every frame MD5-equal to the JAX
    package's decode, every P frame as strips."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "tools"))
    import libde265_tpu as lib
    from gen_inter_streams import make_frames
    from libde265_tpu.encoder import Encoder, EncoderConfig
    from libde265_tpu_torch.api import _parse, decode_stream_native
    from libde265_tpu_torch.parallel.tile_shard import strip_geometry
    W, H = 416, 64
    data = Encoder(EncoderConfig(
        width=W, height=H, qp=30, inter_mode="mv", inter_residual=True,
        tiles=(2, 1), log2_ctb=6, cu_log2=4, num_ref_l0=2,
        temporal_mvp=True, disable_deblocking=False,
        sao=True)).encode(make_frames(3, W, H))
    plans = _parse(data)
    assert strip_geometry(plans[1], 2) == ([0, 192], [192, 224], 256)
    want = lib.decode_stream(data)
    st = {}
    got = decode_stream_native(data, stats=st, tile_devices=["cpu", "cpu"])
    assert (st["n_strip_frames"], st["n_host_frames"]) == (2, 0)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert _md5s(g.planes) == _md5s(w.planes), i
