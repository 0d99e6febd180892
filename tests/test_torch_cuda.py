"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (exact equality) at small sizes, and small streams
decoded on the card against the dec265 MD5s. Marked `cuda`; every test
skips where torch sees no CUDA card. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _plans(name):
    from libde265_tpu_torch.api import _parse
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return _parse(f.read())


def _idr(name, dev):
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    plans = _plans(name)
    cfg = replace(stream_cfg(plans, plans[0].sps), skip_mc=True)
    return cfg, plan_from_numpy(pack_frame(plans[0], cfg, {}), dev)


def _k1_case(dev, H, W, nslots, slot, bitdepth=8):
    """K1 into `slot` of an nslots table of random rows against the plain
    version, luma (T = 16) and the [Cb|Cr] pair (T = 8); uint8 tables at
    8 bits, int16 above."""
    from libde265_tpu_torch.ops.kernels import mc_tables as k
    from libde265_tpu_torch.ops.mc_tile import pad_plane
    rng = np.random.RandomState(H + W)
    dt = torch.uint8 if bitdepth == 8 else torch.int16
    for T, P, pad, (h, w) in ((16, 1, 16, (H, W)),
                              (8, 2, 8, (H // 2, W // 2))):
        padded = pad_plane(torch.as_tensor(
            rng.randint(0, 1 << bitdepth, (P, h, w)), dtype=torch.int16,
            device=dev), pad).contiguous()
        nty = (h + 2 * pad - T + 4) // 4
        ntx = (w + 2 * pad - T + 4) // 4
        rows = nslots * (-(-nty // 8) * 8) * ntx
        init = torch.randint(0, 1 << bitdepth, (rows, P * T * T), dtype=dt,
                             device=dev)
        got, want = init.clone(), init.clone()
        k.update_tile_table(got, padded, slot, T)
        k.update_tile_table_plain(want, padded, slot, T)
        assert torch.equal(got, want), f"K1 T={T}"


@pytest.mark.parametrize("H,W", [(72, 136), (2160, 3840)])
def test_k1_matches_plain(cuda, H, W):
    _k1_case(cuda, H, W, 3, 1)


@pytest.mark.parametrize("H,W", [(64, 304), (16, 16), (72, 136)])
def test_k1_last_slot_matches_plain(cuda, H, W):
    """K1 into the last slot of a 4-slot table. At 64x304 neither the luma
    (81) nor the chroma (41) tile columns fill whole column strips of a
    block; 16x16 has 8x8 chroma planes; at 72x136 the chroma pitch (84)
    is not a multiple of 8 samples, so it stages with 2-byte loads."""
    _k1_case(cuda, H, W, 4, 3)


@pytest.mark.parametrize("H,W,nslots,slot", [
    (64, 304, 4, 3), (16, 16, 4, 3), (72, 136, 4, 3), (2160, 3840, 8, 5)])
def test_k1_int16_matches_plain(cuda, H, W, nslots, slot):
    """K1 writing int16 tables (10-bit samples): the last slot at 64x304,
    16x16 and 72x136 (2-byte staging), and one slot of an 8-slot 4K
    table."""
    _k1_case(cuda, H, W, nslots, slot, bitdepth=10)


def _k3_check(x, g, scfg, xoff, bitdepth, what):
    """K3 on the card against sao_ctb_plain on the same card tensors,
    every plane, exact; one launch a call."""
    from libde265_tpu_torch.ops.kernels import sao_filter as k
    for ci, P in enumerate(x):
        n = k.sao_ctb.launches
        got = k.sao_ctb(P, g, scfg, ci, xoff, bitdepth)
        assert k.sao_ctb.launches == n + 1
        want = k.sao_ctb_plain(P, g, scfg, ci, xoff, bitdepth)
        assert got.shape == want.shape and torch.equal(got, want), \
            (what, ci, int((got != want).sum()))


def _planes(rng, shapes, bitdepth, dev):
    return [torch.as_tensor(rng.randint(0, 1 << bitdepth, s),
                            dtype=torch.int32, device=dev) for s in shapes]


@pytest.mark.parametrize("name", ["p_cif_mixed", "i_deblk_sao"])
def test_k3_matches_plain(cuda, name):
    """K3 on a stream's real grids (the IDR's, as frame_grids leaves
    them: the off grid bit-unpacked to int32) over random planes."""
    from libde265_tpu_torch.frame_program import frame_grids
    cfg, t = _idr(name, cuda)
    g = frame_grids(t, cfg)
    x = _planes(np.random.RandomState(3), [(cfg.H, cfg.W)]
                + [(cfg.H // 2, cfg.W // 2)] * 2, 8, cuda)
    _k3_check(x, g, cfg.scfg, 0, 8, name)


def test_k3_strip_matches_plain(cuda):
    """K3 on one strip of p_tiles4_1080p_mv's first P frame: tile column
    1 (x0 = 448), its real halo-extended grids and xoff = 432, which is
    not a multiple of the CTB width."""
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.packing import stream_cfg
    from libde265_tpu_torch.parallel.tile_shard import HALO_Y, split_strips
    plans = _plans("p_tiles4_1080p_mv")
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    fid_slot = {p.frame_id: i for i, p in enumerate(plans)}
    tsh, trep, x0w = split_strips(plans[1], cfg, fid_slot, 4)
    t = plan_from_numpy(dict(trep, **{k: v[1] for k, v in tsh.items()}),
                        cuda)
    w = t["off"].shape[1] * 4
    x = _planes(np.random.RandomState(5), [(cfg.H, w)]
                + [(cfg.H // 2, w // 2)] * 2, 8, cuda)
    _k3_check(x, t, cfg.scfg, int(x0w[1, 0]) - HALO_Y, 8, "strip 1")


@pytest.mark.parametrize("xoff", [0, -16, 112, -14])
def test_k3_random_matches_plain(cuda, xoff):
    """K3 at 10 bits on seeded random grids (tests/test_torch_ops.py
    _sao_case) of a 176x140 picture, whose chroma pitch (70) is not a
    multiple of 4 samples, and on planes that are column views of wider
    tensors (pitch != width, not 16-byte aligned). At xoff = -14 the
    tiles' first columns are not multiples of 4 samples, so a 64x64 tile
    takes 17 units a row, more than one round of its threads."""
    from test_torch_ops import _sao_case
    x = []
    for ci in range(3):
        xc, g, cfg = _sao_case(7, ci, xoff, 10, W=140)
        x.append(torch.as_tensor(xc, device=cuda))
    g = {k: torch.as_tensor(v, device=cuda) for k, v in g.items()}
    _k3_check(x, g, cfg, xoff, 10, "contiguous")
    views = []
    for P in x:
        wide = torch.zeros((P.shape[0], P.shape[1] + 3), dtype=P.dtype,
                           device=cuda)
        wide[:, 1:1 + P.shape[1]] = P
        views.append(wide[:, 1:1 + P.shape[1]])
    _k3_check(views, g, cfg, xoff, 10, "views")


def _dbk_inputs(name, picks, **kw):
    """Decode `name` on the card with the three callers of K6 recorded
    (the frame program "frame", the tile strips "strip", the hybrid path
    "hybrid"): {(route, i): (planes, grids, fcfg, bitdepth, xoff)}, copies
    of what the route's i-th call received, for each (route, i) in
    `picks`, or for the first `picks` calls of every route if it is an
    int. kw goes to decode_stream_native."""
    import libde265_tpu_torch.frame_program as FP
    import libde265_tpu_torch.ops.filters_fused as FF
    import libde265_tpu_torch.parallel.tile_shard as TS
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels import deblock as k
    got, count = {}, {}

    def recorder(route):
        def rec(Y, Cb, Cr, t, fcfg, bitdepth, xoff=0):
            i = count[route] = count.get(route, -1) + 1
            if (route, i) in picks if not isinstance(picks, int) \
                    else i < picks:
                got[(route, i)] = ([P.clone() for P in (Y, Cb, Cr)],
                                   {g: t[g].clone() for g in k.GRIDS},
                                   fcfg, bitdepth, xoff)
            return k.deblock_frame(Y, Cb, Cr, t, fcfg, bitdepth, xoff)
        rec.launches = 0
        return rec
    with pytest.MonkeyPatch.context() as mp:
        for route, mod in (("frame", FP), ("strip", TS), ("hybrid", FF)):
            mp.setattr(mod, "deblock_frame", recorder(route))
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            decode_stream_native(f.read(), device="cuda", **kw)
    return got


def _k6_check(planes, g, fcfg, bitdepth, xoff, what):
    """K6 (two launches, in place) against deblock_frame_plain on copies
    of the same card tensors, every plane exact. Returns the samples the
    filter changed, per plane."""
    from libde265_tpu_torch.ops.kernels import deblock as k
    want = k.deblock_frame_plain(*(P.clone() for P in planes), g, fcfg,
                                 bitdepth, xoff)
    got = [P.clone() for P in planes]
    n = k.deblock_frame.launches
    out = k.deblock_frame(*got, g, fcfg, bitdepth, xoff)
    assert k.deblock_frame.launches == n + 2
    assert all(o is P for o, P in zip(out, got))            # in place
    torch.cuda.synchronize()
    nplanes = 3 if fcfg[2] else 1
    for ci in range(nplanes):
        assert torch.equal(got[ci], want[ci]), \
            (what, ci, int((got[ci] != want[ci]).sum()))
    return [int((want[ci] != planes[ci]).sum()) for ci in range(nplanes)]


@pytest.mark.parametrize("name,picks,kw", [
    ("ld4k_light", (("frame", 0), ("frame", 1)), {}),
    ("ldb4k_main10", (("frame", 1),), {}),
    ("gop1080p", (("frame", 0),), {}),
    ("p_tiles4_1080p_mv", (("strip", 1),),
     {"tile_devices": ["cuda:0"] * 4})])
def test_k6_stream_matches_plain(cuda, name, picks, kw):
    """K6 on the real grids and pre-deblocking planes of an ld4k_light
    IDR and P picture, an ldb4k_main10 B picture (10 bits, bi-prediction:
    the two-MV bS rule), a gop1080p IDR and strip 1 of p_tiles4_1080p_mv's
    first P frame (xoff 432, halo-extended uint8 grids)."""
    got = _dbk_inputs(name, picks, **kw)
    assert sorted(got) == sorted(picks)
    for key, (planes, g, fcfg, bd, xoff) in got.items():
        if key[0] == "strip":
            assert xoff == 432 and g["off"].dtype == torch.uint8
        if name == "ldb4k_main10":
            assert bd == 10 and bool((g["pf"].sum(-1) == 2).any())
        changed = _k6_check(planes, g, fcfg, bd, xoff, (name, key))
        # chroma filters only bS 2 (intra) edges: inter pictures may have
        # none
        assert changed[0] and (all(changed) or key[1] > 0), \
            (name, key, changed)


@pytest.mark.parametrize("name,kw", [
    ("rext_422_filters", {}), ("rext_444_filters", {}),
    ("rext_mono_filters", {}), ("adv_pcm_mono", {}), ("p_pcm", {}),
    ("p_pcm_nolf", {}), ("p_tqbypass", {}), ("p_tiles_nolf", {}),
    ("p_tiles2_mv_nolf", {"tile_devices": ["cuda:0"] * 2}),
    ("p_mixedlf", {}), ("rxt_cqo", {})])
def test_k6_vectors_match_plain(cuda, name, kw):
    """K6 on the first three calls of each route while small vectors
    decode on the card: 4:2:2, 4:4:4 and monochrome, pcm blocks (with the
    SPS's pcm_loop_filter_disabled_flag in p_pcm_nolf), transquant bypass,
    tile-boundary filtering off (p_tiles_nolf, and p_tiles2_mv_nolf's
    strips), a slice with deblocking disabled beside one with it on
    (p_mixedlf), and the hybrid path (rxt_cqo). No committed vector codes
    nonzero slice beta / tc offsets: the synthetic cases below do."""
    got = _dbk_inputs(name, 3, **kw)
    assert got
    if kw:
        assert any(r == "strip" for r, _ in got)
    if name == "rxt_cqo":
        assert any(r == "hybrid" for r, _ in got)
    for key, (planes, g, fcfg, bd, xoff) in got.items():
        _k6_check(planes, g, fcfg, bd, xoff, (name, key))


def _dbk_case(seed, H, W, chroma_fmt, bitdepth, xoff=0, log2ctb=5,
              narrow=False, Wpic=None):
    """Seeded inputs of K6 (numpy): piecewise-smooth planes (8x8 blocks of
    a level with flat, gentle or textured noise, steps between
    neighbours, a ramp) so that both filters and every decision are
    taken; random grids with many blocks copying their left or upper
    neighbour's motion (bS 0 through the motion rule), some of those
    nudged by up to 4, some with their lists swapped or both lists on one
    picture; 4 slice rows with random disable flags and beta / tc offsets
    in -6..6; random CTB-boundary permissions, pcm / bypass blocks and
    chroma QP offsets. narrow: the strips' and the hybrid path's dtypes
    (uint8 grids, int16 motion, QPs down to -6 * (bitdepth - 8)). With
    xoff the planes are a strip of a Wpic-wide picture whose first column
    sits at global luma x = xoff. Returns (planes, grids, fcfg)."""
    rng = np.random.RandomState(seed)
    gh, gw = H // 4, W // 4
    Wpic = Wpic or W
    ctb = 1 << log2ctb
    nctby, nctbx = -(-H // ctb), -(-Wpic // ctb)
    S = 4
    i4 = np.uint8 if narrow else np.int32
    mvt = np.int16 if narrow else np.int32

    def plane(h, w, bs):
        nb = (-(-h // bs), -(-w // bs))
        lvl = rng.randint(0, 1 << bitdepth, nb)
        amp = rng.choice([0, 0, 1, 2, 4, 16, 1 << (bitdepth - 3)], nb)
        step = rng.randint(-6, 7, nb) << (bitdepth - 8)
        lvl = np.where(rng.rand(*nb) < 0.6,
                       np.roll(lvl, 1, axis=1) + step, lvl)
        one = np.ones((bs, bs), np.int64)
        base = np.kron(lvl, one)[:h, :w]
        noise = (rng.rand(h, w) * 2 - 1) * np.kron(amp, one)[:h, :w]
        ramp = np.arange(w)[None, :] * rng.randint(0, 3) \
            + np.arange(h)[:, None] * rng.randint(0, 3)
        return np.clip(base + noise + ramp, 0, (1 << bitdepth) - 1) \
            .astype(np.int32)
    subw = 2 if chroma_fmt in (1, 2) else 1
    subh = 2 if chroma_fmt == 1 else 1
    planes = [plane(H, W, 8)]
    planes += [plane(H // subh, W // subw, 4) if chroma_fmt
               else np.zeros((1, 128), np.int32) for _ in range(2)]
    g = {"pm": rng.choice([0, 0, 0, 1, 2], (gh, gw)).astype(i4),
         "cbf": (rng.rand(gh, gw) < 0.3).astype(i4),
         "tucb": rng.randint(0, 4, (gh, gw)).astype(i4),
         "edgeall": np.where(rng.rand(gh, gw) < 0.85, 3,
                             rng.randint(0, 3, (gh, gw))).astype(i4),
         "qp": rng.randint(-6 * (bitdepth - 8) if narrow else 10, 52,
                           (gh, gw)).astype(np.int8),
         "off": (rng.rand(gh, gw) < 0.08).astype(i4),
         "pf": rng.randint(0, 2, (gh, gw, 2)).astype(i4),
         "mv": rng.randint(-9, 10, (gh, gw, 2, 2)).astype(mvt),
         "poc": rng.randint(0, 3, (gh, gw, 2)).astype(mvt),
         "sidx": rng.randint(0, S, (nctby, nctbx)).astype(np.int32),
         "allow_v": rng.rand(nctby, nctbx) < 0.7,
         "allow_h": rng.rand(nctby, nctbx) < 0.7,
         "sh_disable": (rng.rand(S) < 0.25).astype(np.int32),
         "sh_beta": rng.randint(-6, 7, S).astype(np.int32),
         "sh_tc": rng.randint(-6, 7, S).astype(np.int32)}
    motion = (g["pf"], g["mv"], g["poc"])
    for axis, share in ((1, 0.4), (0, 0.3)):
        cp = rng.rand(gh, gw) < share
        for j in range(1, gw if axis else gh):
            for a in motion:
                if axis:
                    a[cp[:, j], j] = a[cp[:, j], j - 1]
                else:
                    a[j, cp[j]] = a[j - 1, cp[j]]
    nudge = rng.rand(gh, gw) < 0.3
    g["mv"][nudge] += rng.randint(-4, 5, (int(nudge.sum()), 2, 2)) \
        .astype(mvt)
    sw = rng.rand(gh, gw) < 0.15
    for a in motion:
        a[sw] = a[sw][:, ::-1].copy()
    dup = rng.rand(gh, gw) < 0.2
    g["poc"][dup, 1] = g["poc"][dup, 0]
    fcfg = (log2ctb, False, chroma_fmt, bitdepth, bitdepth,
            int(rng.randint(-4, 5)), int(rng.randint(-4, 5)), H, Wpic)
    return planes, g, fcfg


# (seed, H, W, chroma format, bit depth, xoff, log2 CTB, narrow, Wpic)
DBK_CASES = [(0, 64, 96, 1, 8, 0, 5, False, None),
             (1, 48, 80, 1, 12, 0, 4, False, None),
             (2, 64, 72, 2, 10, 0, 4, True, None),
             (3, 40, 56, 3, 8, 0, 4, True, None),
             (4, 64, 64, 0, 12, 0, 6, False, None),
             (5, 64, 96, 1, 8, -16, 5, True, 96),
             (6, 64, 80, 1, 10, 112, 5, True, 136),
             (7, 56, 104, 3, 12, 0, 5, False, None),
             (8, 72, 84, 2, 8, 0, 4, False, None)]


@pytest.mark.parametrize("case", DBK_CASES)
def test_k6_synthetic_matches_plain(cuda, case):
    """K6 on seeded synthetic planes and grids (_dbk_case) at 8, 10 and
    12 bits, every chroma format, CTBs of 16, 32 and 64, widths that are
    not multiples of 8 (84: a 4:2:2 horizontal chroma edge beyond the
    last luma one), the first strip of a tile column (xoff -16) and one
    that runs past the picture's last CTB column (xoff 112 in a 136-wide
    picture); then the same planes as column views of wider tensors
    (pitch != width, not 16-byte aligned)."""
    seed, H, W, fmt, bd, xoff, l2, narrow, wpic = case
    planes, g, fcfg = _dbk_case(seed, H, W, fmt, bd, xoff, l2, narrow, wpic)
    P = [torch.as_tensor(x, device=cuda) for x in planes]
    g = {k: torch.as_tensor(v, device=cuda) for k, v in g.items()}
    changed = _k6_check(P, g, fcfg, bd, xoff, case)
    assert all(changed), (case, changed)
    views = []
    for x in P:
        wide = torch.zeros((x.shape[0], x.shape[1] + 3), dtype=x.dtype,
                           device=cuda)
        wide[:, 1:1 + x.shape[1]] = x
        views.append(wide[:, 1:1 + x.shape[1]])
    _k6_check(views, g, fcfg, bd, xoff, (case, "views"))


@pytest.mark.parametrize("name,holes", [("intra_104x72_q26", False),
                                        ("intra_104x72_q26", True),
                                        ("p_cif_mixed", False),
                                        ("ld1080p_light", False),
                                        ("p_tiles4_1080p_mv", False),
                                        ("adv_cra_scaling_10b_amp", False),
                                        ("rext_420_inter_12b", False)])
def test_k4_matches_plain(cuda, name, holes):
    """K4 (the band wavefront) against its plain serial version, 10
    launches per plane group, every output equal: small IDRs (with and
    without availability holes), a 17-band 1080p IDR, the IDR of the
    4-column tile stream, whose slots are in tile-scan order, and a
    10-bit and a 12-bit IDR (planes of that many bits)."""
    from libde265_tpu_torch.intra_fused import avail_spans, scan_groups
    from libde265_tpu_torch.ops.kernels import intra_scan as k
    cfg, t = _idr(name, cuda)
    rng = np.random.RandomState(4)
    for idx, kw in scan_groups(t, cfg):
        if holes:
            av = kw["avail"].clone()
            for r in range(av.shape[0]):
                ones = av[r].nonzero().flatten().tolist()
                if len(ones) >= 3 and rng.rand() < 0.33:
                    av[r, ones[rng.randint(1, len(ones) - 1)]] = 0
            kw = dict(kw, avail=av.contiguous(), spans=avail_spans(av))
        dims = [(cfg.H, cfg.W)] + [cfg.chroma_dims] * 2
        planes = [torch.as_tensor(rng.randint(0, 1 << cfg.bitdepth,
                                              dims[i]),
                                  dtype=torch.int32, device=cuda)
                  for i in idx]
        want = [p.clone() for p in planes]
        k.intra_scan_plain(want, **kw)
        for rep in range(10):
            got = [p.clone() for p in planes]
            k.intra_scan(got, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, idx, rep)


def _k2_case(seed, H, W, R, bitdepth, bi, weighted, dev):
    """Seeded random K2 inputs on `dev`: tile tables of R slots (uint8
    for 8 bits, int16 above), MVs up to +-2^14, a random inter mask."""
    from libde265_tpu_torch.packing import n_tiles_c, n_tiles_y
    rng = np.random.RandomState(seed)
    maxv = (1 << bitdepth) - 1
    dt = np.uint8 if bitdepth == 8 else np.int16
    N = (H // 4) * (W // 4)
    tabs = [rng.randint(0, maxv + 1, (R * a * b, w)).astype(dt)
            for (a, b), w in ((n_tiles_y(H, W), 256),
                              (n_tiles_c(H // 2, W // 2), 128))]
    mv = rng.randint(-(1 << 14), 1 << 14, (N, 2, 2)).astype(np.int32)
    near = rng.rand(N) < 0.7
    mv[near] = rng.randint(-64, 64, (int(near.sum()), 2, 2))
    pf = np.stack([np.ones(N, np.int32),
                   rng.randint(0, 2, N).astype(np.int32) * bi], axis=1)
    slot = rng.randint(0, R, (N, 2)).astype(np.int32)
    w = ex = None
    if weighted:
        w = np.zeros((N, 3, 5), np.int32)
        w[:, :, 4] = rng.randint(0, 8, (N, 3)) + 14 - bitdepth
        w[:, :, 0] = rng.randint(-128, 128, (N, 3))
        w[:, :, 2] = rng.randint(-128, 128, (N, 3))
        w[:, :, 1] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
        w[:, :, 3] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
        ex = (rng.rand(N) < 0.7).astype(np.int32)
    inter = rng.rand(H // 4, W // 4) < 0.9
    t = [None if a is None else torch.as_tensor(a, device=dev)
         for a in (mv, slot, pf, w, ex, inter)]
    return [torch.as_tensor(a, device=dev) for a in tabs], t


@pytest.mark.parametrize("H,W,bitdepth,bi,weighted", [
    (64, 128, 8, False, False), (64, 128, 8, True, True),
    (72, 136, 10, True, True), (64, 128, 12, False, True),
    (1080, 1920, 8, True, True)])
def test_k2_matches_plain(cuda, H, W, bitdepth, bi, weighted):
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    tabs, (mv, slot, pf, w, ex, inter) = _k2_case(H + bitdepth, H, W, 4,
                                                  bitdepth, bi, weighted,
                                                  cuda)
    for tab in tabs:
        args = (tab, (H, W), mv, slot, pf, w, ex, inter, bitdepth, bi)
        n = mc_predict.launches
        got = mc_predict(*args)
        want = mc_predict_plain(*args)
        assert mc_predict.launches == n + 1
        for g, p in zip(got, want):
            assert torch.equal(g, p), (tab.shape, bitdepth)


@pytest.mark.parametrize("name", ["p_cif_mixed", "b_mv", "intra_104x72_q26",
                                  "p_wp", "adv_b_wp_2ref", "b_mixed"])
def test_decode_on_card(cuda, name):
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    mf = {"intra_": "manifest.json", "adv_": "manifest_adv.json"}.get(
        name[:name.index("_") + 1], "manifest_inter.json")
    with open(os.path.join(DATA, mf)) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    n1, n2, n3 = (update_tile_table.launches, mc_predict.launches,
                  sao_ctb.launches)
    pics = decode_stream_native(data, device="cuda")
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    assert update_tile_table.launches - n1 == 2 * len(pics)
    assert sao_ctb.launches >= n3
    if not name.startswith("intra_"):
        assert mc_predict.launches - n2 >= 2


@pytest.mark.parametrize("H,W,R,bitdepth", [(72, 136, 3, 10),
                                             (1080, 1920, 2, 8),
                                             (48, 96, 2, 12)])
def test_k5_matches_plain(cuda, H, W, R, bitdepth):
    from libde265_tpu_torch.ops.kernels import mc_tables as k
    from libde265_tpu_torch.ops.mc_tile import pad_refs
    rng = np.random.RandomState(H + R)
    maxv = (1 << bitdepth) - 1
    py, pc = pad_refs(*(torch.as_tensor(rng.randint(0, maxv + 1, (R, h, w)),
                                        dtype=torch.int16, device=cuda)
                        for h, w in ((H, W), (H // 2, W // 2),
                                     (H // 2, W // 2))))
    dt = torch.uint8 if bitdepth == 8 else torch.int16
    n = k.build_tile_tables.launches
    got = k.build_tile_tables(py, pc, dt)
    assert k.build_tile_tables.launches == n + 2
    for g, w in zip(got, k.build_tile_tables_plain(py, pc, dt)):
        assert g.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("x0,Ws,bi", [(0, 128, False), (128, 128, True),
                                      (192, 128, True)])
def test_k2_strip_matches_plain(cuda, x0, Ws, bi):
    """K2 in strip form (the tile-column decoder's) on 64x256 reference
    tables; the strip at x0 = 192 runs past the frame's right edge."""
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    H, W = 64, 256
    tabs, _ = _k2_case(x0, H, W, 3, 8, bi, True, cuda)
    _, (mv, slot, pf, w, ex, inter) = _k2_case(x0 + 1, H, Ws, 3, 8, bi,
                                               True, cuda)
    for tab in tabs:
        args = (tab, (H, W), mv, slot, pf, w, ex, inter, 8, bi)
        got = mc_predict(*args, strip=Ws, x0=x0)
        want = mc_predict_plain(*args, strip=Ws, x0=x0)
        for g, p in zip(got, want):
            assert g.shape == p.shape and torch.equal(g, p), tab.shape


@pytest.mark.parametrize("bitdepth,bi,inter,strip", [
    (8, False, "none", None), (8, False, "checker", None),
    (12, False, "random", None), (12, True, "checker", None),
    (8, False, "random", 128), (12, True, "random", 128)])
def test_k2_edges_match_plain(cuda, bitdepth, bi, inter, strip):
    """K2 at the edges of its design against the plain version: launches
    without list 1, an all-false and a checkerboard inter mask, MVs that
    clamp past every edge and corner of the frame, int16 tables at 12
    bits, and a strip of width 128 at the last tile column (x0 = 128 of a
    256-wide frame)."""
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    H, W = 64, 256
    Wo, x0 = (W, 0) if strip is None else (strip, W - strip)
    tabs, _ = _k2_case(bitdepth, H, W, 3, bitdepth, bi, True, cuda)
    _, (mv, slot, pf, w, ex, mask) = _k2_case(bitdepth + 1, H, Wo, 3,
                                              bitdepth, bi, True, cuda)
    far = 1 << 14
    edge = torch.tensor([[-far, 0], [far, 0], [0, -far], [0, far],
                         [-far, -far], [far, far], [-far, far], [far, -far]],
                        dtype=torch.int32, device=cuda)
    sel = torch.arange(mv.shape[0], device=cuda) % 10
    mv = torch.where((sel < 8)[:, None, None],
                     edge[sel.clamp(max=7)][:, None, :].expand(-1, 2, -1),
                     mv).contiguous()
    yy, xx = torch.meshgrid(torch.arange(H // 4, device=cuda),
                            torch.arange(Wo // 4, device=cuda),
                            indexing="ij")
    mask = {"none": torch.zeros_like(mask), "random": mask,
            "checker": (yy + xx) % 2 == 0}[inter].contiguous()
    for tab in tabs:
        args = (tab, (H, W), mv, slot, pf, w, ex, mask, bitdepth, bi)
        got = mc_predict(*args, strip=strip, x0=x0)
        want = mc_predict_plain(*args, strip=strip, x0=x0)
        for g, p in zip(got, want):
            assert g.shape == p.shape and torch.equal(g, p), tab.shape


@pytest.mark.parametrize("name,ndev", [
    ("p_tiles2_mv", 2), ("p_tiles2_mv_nolf", 2), ("p_tiles3r_mv", 3),
    ("p_tiles4_mv", 4), ("p_tiles8_mv", 8), ("p_tiles8nu_mv", 8),
    ("p_tiles4_1080p_mv", 4)])
def test_tile_decode_on_card(cuda, name, ndev):
    """The tile-column decoder with every strip on the one card: every
    frame MD5-equal, every P frame decoded as strips through K5 and K2."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.mc_tables import build_tile_tables
    mf = "manifest_torch.json" if "1080p" in name else "manifest_inter.json"
    with open(os.path.join(DATA, mf)) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    n5 = build_tile_tables.launches
    st = {}
    pics = decode_stream_native(data, stats=st, tile_devices=["cuda"] * ndev)
    assert len(pics) == m["frames"] and st["n_host_frames"] == 0
    assert st["n_strip_frames"] == m["frames"] - 1
    assert build_tile_tables.launches - n5 == 2 * st["n_strip_frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i


BIG = ["bigmv_720p", "gop1080p", "intra_720p", "ld1080p_light",
       "ld1080p_light_wppb", "ld4k", "ld4k_light", "ld4k_light_wppb",
       "ld4k_mixed", "ld720p_light", "ld_1080p_wpp", "ld_720p_wpp",
       "mixedmv_720p", "tiles44_1080p"]


@pytest.mark.parametrize("name", BIG)
def test_big_stream_on_card(cuda, name):
    """Every stream of manifest_big.json (720p to 4K) decoded on the card,
    every frame MD5-equal, none on the numpy host path."""
    from libde265_tpu_torch.api import decode_stream_native
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    st = {}
    pics = decode_stream_native(data, device="cuda", stats=st)
    assert len(pics) == m["frames"] and st["n_host_frames"] == 0
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i


PART_B = {"p_tskip": 0, "p_tqbypass": 0, "i_tskip_nxn": 0, "p_pcm": 0,
          "p_pcm_nolf": 0, "p_scaling": 0, "adv_lossless_tskip_partial": 0,
          "adv_rice_tiles": 0, "adv_tiles_lossless": 0,
          "adv_dep_pcm_strong": 0, "adv_ltr_tsa_scaling": 0,
          "adv_erdpcm_dep": 3, "rxt_erdpcm": 3, "rxt_erdpcm_rot_tsctx": 3}


@pytest.mark.parametrize("name,host_frames", sorted(PART_B.items()))
def test_residual_tools_on_card(cuda, name, host_frames):
    """The 4:2:0 residual tools (transform-skip, transquant bypass, PCM,
    scaling lists) decoded on the card: every frame MD5-equal, the frames
    frame_compatible rejects (host_frames: explicit RDPCM) on the hybrid
    device path, none on the numpy host path, K4 launched for the intra
    TUs."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    mf = {"adv_": "manifest_adv.json", "rxt_": "manifest_rext_tools.json"
          }.get(name[:name.index("_") + 1], "manifest_inter.json")
    with open(os.path.join(DATA, mf)) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    n4 = intra_scan.launches
    st = {}
    pics = decode_stream_native(data, device="cuda", stats=st)
    assert len(pics) == m["frames"]
    assert (st["n_hybrid_frames"], st["n_host_frames"]) == (host_frames, 0)
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    assert intra_scan.launches > n4


@pytest.mark.parametrize("name,copies", [
    ("p_cif_mixed", 1), ("p_mixed", 1), ("i_deblk_sao", 1), ("p_pcm", 1),
    ("p_mv", 3)])
def test_runs_on_card(cuda, name, copies):
    """decode_all's runs on the card (slots planned ahead, a run packed
    as one blob, the C++ writer's frames among them, one upload a run)
    against a second decoder fed frame by frame (decode_plan): the same
    K1-K4 launches, final state and slot map, and every output picture
    MD5-equal; both equal to decode_all on the CPU. p_mv three times
    (12 frames) runs on past evictions of pictures still to be
    output."""
    import hashlib
    from libde265_tpu_torch import telemetry
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.parallel.gop_parallel import _counters
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        from libde265_tpu_torch.api import _parse
        plans = _parse(f.read() * copies)
    counters = _counters()[:4]

    def run(dev, by_frame=False):
        dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
        torch.cuda.synchronize()
        before = [f.launches for f in counters]
        if by_frame:
            for i, p in enumerate(plans):
                dec.decode_plan(p, i)
        else:
            dec.decode_all()
        torch.cuda.synchronize()
        return dec, [f.launches - b for f, b in zip(counters, before)]

    telemetry.clear()
    dec, ln = run("cuda")
    native = telemetry.totals().get("pack.native", (0, 0.0, 0))[2]
    ref, ln_ref = run("cuda", by_frame=True)
    cpu, _ = run("cpu")
    assert ln == ln_ref and ln[0] == 2 * len(plans)
    assert dec.slot_of == ref.slot_of == cpu.slot_of
    for a, b, c in zip(dec.state(), ref.state(), cpu.state()):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    if copies > 1:
        assert native > 0
    n = 0
    for i, p in enumerate(plans):
        got = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
               for a in dec.planes_of(p.frame_id)]
        want = [m["md5"][i % m["frames"]][k] for k in ("y", "u", "v")]
        assert got == want, i
        n += 1
    assert n == len(plans)


# the 4:2:0 vectors above 8 bits -> frames frame_compatible rejects
HBD = {"p_10bit": 0, "rext_420_inter_12b": 0, "rxt_cqo_10b": 3,
       "rxt_rice_scaling_10b": 0, "adv_cra_scaling_10b_amp": 0,
       "adv_wpp_dep10_scaling": 0}


@pytest.mark.parametrize("name,host_frames", sorted(HBD.items()))
def test_high_bit_depth_on_card(cuda, name, host_frames):
    """10- and 12-bit 4:2:0 decoded on the card (int16 tile tables,
    uint16 pictures): every frame MD5-equal (of 16-bit little-endian
    samples), the hybrid device path for the frames frame_compatible
    rejects (TU-level chroma QP offsets), none on the numpy host path, K1
    two launches a frame."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    mf = {"adv_": "manifest_adv.json", "rxt_": "manifest_rext_tools.json",
          "rext_": "manifest_rext.json"}.get(name[:name.index("_") + 1],
                                             "manifest_inter.json")
    with open(os.path.join(DATA, mf)) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    n1 = update_tile_table.launches
    st = {}
    pics = decode_stream_native(data, device="cuda", stats=st)
    assert len(pics) == m["frames"]
    assert (st["n_hybrid_frames"], st["n_host_frames"]) == (host_frames, 0)
    assert pics[0].planes[0].dtype == np.uint16
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    # hybrid frames are inserted with K1 as well
    assert update_tile_table.launches - n1 == 2 * len(pics)


def test_gop_decode_on_card(cuda):
    """The GOP decoder on two GOPs (p_mv twice over) on ["cuda:0"] * 2,
    one CUDA stream per entry: every frame MD5-equal, and the launches
    of the single-decoder decode of the same stream."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        m = json.load(f)["p_mv"]
    with open(os.path.join(DATA, "p_mv.bin"), "rb") as f:
        data = f.read() * 2
    counters = (update_tile_table, mc_predict, sao_ctb, intra_scan)
    launches = []
    for kw in (dict(gop_devices=["cuda:0"] * 2), dict(device="cuda")):
        n = [c.launches for c in counters]
        st = {}
        pics = decode_stream_native(data, stats=st, **kw)
        launches.append([c.launches - a for c, a in zip(counters, n)])
        assert len(pics) == 2 * m["frames"] and st["n_host_frames"] == 0
        for i, pic in enumerate(pics):
            got = [pic.plane_md5(c) for c in range(3)]
            assert got == [m["md5"][i % m["frames"]][k]
                           for k in ("y", "u", "v")], (kw, i)
    assert launches[0] == launches[1] and launches[0][3] >= 2


# ---- 4:2:2, 4:4:4 and monochrome
def _chroma_vectors():
    """{name: (manifest entry)} of the committed non-4:2:0 vectors."""
    out = {}
    for mf in ("manifest_rext.json", "manifest_adv.json",
               "manifest_rext_tools.json"):
        with open(os.path.join(DATA, mf)) as f:
            out.update((k, v) for k, v in json.load(f).items()
                       if v["chroma_format"] != 1)
    return out


CHROMA = _chroma_vectors()


@pytest.mark.parametrize("name", ["rext_422_104x72", "adv_422_tiles_tskip",
                                  "adv_pcm_422", "rext_444_104x72",
                                  "rext_mono_104x72"])
def test_k4_chroma_formats_match_plain(cuda, name):
    """K4 on IDRs of every format against its plain serial version, 20
    launches per plane group, every output equal (a race between bands
    would show): 4:2:2 chroma bands are 64 rows with columns 16 wide
    (BW != BH, one of them in tile scan), 4:4:4 chroma is smoothed, and
    monochrome has one group."""
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels import intra_scan as k
    cfg, t = _idr(name, cuda)
    rng = np.random.RandomState(6)
    groups = scan_groups(t, cfg)
    assert len(groups) == (1 if cfg.mono else 2)
    for idx, kw in groups:
        if idx == (1, 2) and cfg.chroma_fmt == 2:
            assert kw["BW"] * 2 == kw["BH"]
        dims = [(cfg.H, cfg.W)] + [cfg.chroma_dims] * 2
        planes = [torch.as_tensor(rng.randint(0, 1 << cfg.bitdepth,
                                              dims[i]),
                                  dtype=torch.int32, device=cuda)
                  for i in idx]
        want = [p.clone() for p in planes]
        k.intra_scan_plain(want, **kw)
        for rep in range(20):
            got = [p.clone() for p in planes]
            n = k.intra_scan.launches
            k.intra_scan(got, **kw)
            assert k.intra_scan.launches == n + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, idx, rep)


@pytest.mark.parametrize("name", ["rext_422_filters", "rext_444_filters",
                                  "adv_422_tiles_tskip"])
def test_k3_chroma_formats_match_plain(cuda, name):
    """K3 with every frame's real SAO parameters at 4:2:2 (chroma CTBs
    half as wide as tall) and 4:4:4, over random planes: contiguous, and
    column views of wider tensors (pitch != width, not 16-byte aligned:
    the scalar path)."""
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids
    from libde265_tpu_torch.packing import (frame_has_mc, pack_frame,
                                            stream_cfg)
    plans = _plans(name)
    cfg = stream_cfg(plans, plans[0].sps)
    assert cfg.sao_enabled and cfg.chroma_fmt in (2, 3)
    fid_slot = {p.frame_id: i % 8 for i, p in enumerate(plans)}
    rng = np.random.RandomState(8)
    for plan in plans:
        v = cfg if frame_has_mc(plan) else replace(cfg, skip_mc=True)
        g = frame_grids(plan_from_numpy(pack_frame(plan, v, fid_slot),
                                        cuda), v)
        x = _planes(rng, [(v.H, v.W)] + [v.chroma_dims] * 2, v.bitdepth,
                    cuda)
        _k3_check(x, g, v.scfg, 0, v.bitdepth, (name, plan.frame_id))
        views = []
        for P in x:
            wide = torch.zeros((P.shape[0], P.shape[1] + 3), dtype=P.dtype,
                               device=cuda)
            wide[:, 1:1 + P.shape[1]] = P
            views.append(wide[:, 1:1 + P.shape[1]])
        _k3_check(views, g, v.scfg, 0, v.bitdepth, (name, "views"))


def _decode_chroma(name, manifest_entry, dev_kw):
    """Decode on the card: MD5s per the manifest's keys (luma only for
    monochrome, whose chroma planes are empty); returns (pics, stats, K1
    launches)."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    n1 = update_tile_table.launches
    st = {}
    pics = decode_stream_native(data, stats=st, **dev_kw)
    m = manifest_entry
    keys = ("y", "u", "v") if m["chroma_format"] else ("y",)
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        assert pic.chroma_format == m["chroma_format"]
        assert [pic.plane_md5(c) for c in range(len(keys))] == \
            [m["md5"][i][k] for k in keys], (name, i)
        if not m["chroma_format"]:
            assert pic.planes[1].size == pic.planes[2].size == 0
    return pics, st, update_tile_table.launches - n1


@pytest.mark.parametrize("name", sorted(CHROMA))
def test_chroma_formats_on_card(cuda, name):
    """The 31 4:2:2 / 4:4:4 / monochrome vectors decoded on the card:
    MD5-equal, the host path only for the frames frame_compatible
    rejects (cross-component prediction), K1 one launch a frame (the
    luma table; host frames are inserted with it too)."""
    from libde265_tpu_torch.packing import frame_compatible
    pics, st, k1 = _decode_chroma(name, CHROMA[name], dict(device="cuda"))
    rejected = sum(not frame_compatible(p) for p in _plans(name))
    assert st["n_host_frames"] == rejected
    assert k1 == len(pics)


def test_ld4k_422_on_card(cuda):
    """ld4k_422_10b (3840x2160 HEVC Main 4:2:2 10, IDR + 8 P frames):
    MD5-equal to manifest_torch.json, no host frame, launches K1 1 a
    frame, K2 1 a P frame, K3 3 a frame, K4 2."""
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    with open(os.path.join(DATA, "manifest_torch.json")) as f:
        m = json.load(f)["ld4k_422_10b"]
    counters = (mc_predict, sao_ctb, intra_scan)
    n = [c.launches for c in counters]
    pics, st, k1 = _decode_chroma("ld4k_422_10b", m, dict(device="cuda"))
    ln = [c.launches - a for c, a in zip(counters, n)]
    assert st["n_host_frames"] == 0 and pics[0].planes[1].shape == \
        (2160, 1920)
    assert [k1] + ln == [9, 8, 27, 2]


# the committed vectors with frames on the hybrid device path -> hybrid
# frames (TU-level chroma QP offsets, explicit RDPCM)
HYBRID = {"rxt_cqo": 4, "adv_cqo_tiles": 4, "rxt_cqo_10b": 3,
          "rxt_erdpcm": 3, "rxt_erdpcm_rot_tsctx": 3, "adv_erdpcm_dep": 3}


@pytest.mark.parametrize("name,hybrid", sorted(HYBRID.items()))
def test_hybrid_path_on_card(cuda, name, hybrid):
    """The hybrid device path on the card: every frame MD5-equal, the
    refused frames hybrid and none on the numpy host path, K1 two
    launches a frame (hybrid inserts included), and the final DPB stacks,
    tile tables and slot map equal to the same decode on the CPU (the
    kernels' plain versions)."""
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    mf = {"adv_": "manifest_adv.json", "rxt_": "manifest_rext_tools.json"
          }[name[:name.index("_") + 1]]
    with open(os.path.join(DATA, mf)) as f:
        m = json.load(f)[name]
    plans = _plans(name)
    n1 = update_tile_table.launches
    dec = DeviceStreamDecoder(plans, plans[0].sps, "cuda")
    dec.decode_all()
    assert (dec.n_hybrid_frames, dec.n_host_frames) == (hybrid, 0)
    assert update_tile_table.launches - n1 == 2 * len(plans)
    for i, p in enumerate(plans):
        got = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
               for a in dec.planes_of(p.frame_id)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    ref = DeviceStreamDecoder(_plans(name), plans[0].sps, "cpu")
    ref.decode_all()
    assert dec.slot_of == ref.slot_of
    for a, b in zip(dec.state(), ref.state()):
        assert torch.equal(a.cpu(), b)


def test_scaling_list_hybrid_vector_on_card(cuda):
    """rxt_cqo_scaling (scaling lists, transform skip and CU chroma QP
    offsets; made by the port's encoder) on the card: every frame on the
    hybrid path, MD5-equal to manifest_torch.json, and the final state
    equal to the CPU decode's."""
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    name = "rxt_cqo_scaling"
    with open(os.path.join(DATA, "manifest_torch.json")) as f:
        m = json.load(f)[name]
    plans = _plans(name)
    dec = DeviceStreamDecoder(plans, plans[0].sps, "cuda")
    dec.decode_all()
    assert (dec.n_hybrid_frames, dec.n_host_frames) == (4, 0)
    for i, p in enumerate(plans):
        got = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
               for a in dec.planes_of(p.frame_id)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    ref = DeviceStreamDecoder(_plans(name), plans[0].sps, "cpu")
    ref.decode_all()
    for a, b in zip(dec.state(), ref.state()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("tiles", [2, 4])
def test_tile_mesh_on_card(cuda, tiles):
    """parallel.tile_mesh on ["cuda:0"] * tiles: the plane and the int64
    checksum equal to the CPU run, the plane on the card."""
    from libde265_tpu_torch.parallel import tile_mesh as T
    H, W, n_tu = 272, 480, 64
    inp = T.demo_inputs(H, W, tiles, n_tu)
    got = T.make_tile_recon_step(["cuda:0"] * tiles, H, W, tiles,
                                 n_tu)(*inp)
    want = T.make_tile_recon_step(["cpu"] * tiles, H, W, tiles, n_tu)(*inp)
    assert got[0].is_cuda and got[1].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_quality_on_card(cuda):
    """utils.quality on card tensors equals the values of the same planes
    on the CPU (ssd / sad / mse exact, psnr / ssim to 1e-12)."""
    from libde265_tpu_torch.utils import quality as Q
    rng = np.random.RandomState(5)
    a = rng.randint(0, 1024, (1080, 1920)).astype(np.uint16)
    b = np.clip(a.astype(np.int64) + rng.randint(-7, 8, a.shape), 0,
                1023).astype(np.uint16)
    ta = torch.as_tensor(a.astype(np.int32), device="cuda")
    tb = torch.as_tensor(b.astype(np.int32), device="cuda")
    for f in (Q.ssd, Q.sad, Q.mse):
        assert f(ta, tb) == f(a, b)
    assert Q.psnr(ta, tb, 1023) == pytest.approx(Q.psnr(a, b, 1023),
                                                 rel=1e-12)
    assert Q.ssim(ta, tb) == pytest.approx(Q.ssim(a, b), rel=1e-12)


@pytest.mark.parametrize("settings", [
    dict(inter_mode="gmv", global_mv=(-20, -12), inter_residual=True,
         log2_ctb=6, cu_log2=4, num_ref_l0=2, temporal_mvp=True, sao=True,
         disable_deblocking=False, write_hash_sei=True, qp=37),
    dict(inter_mode="mixed", inter_residual=True, tiles=(2, 1), sao=True,
         disable_deblocking=False)])
def test_port_encoded_stream_on_card(cuda, settings):
    """A stream from the port's encoder decoded on the card: every frame
    equal to the encoder's reconstruction."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.encoder import Encoder, EncoderConfig
    rng = np.random.RandomState(12)
    H, W = 128, 192
    base = np.kron(rng.randint(0, 256, (H // 8 + 4, W // 8 + 8)),
                   np.ones((8, 8), np.int64))
    frames = [[np.clip(base[t:t + H, 2 * t:2 * t + W], 0, 255)
               .astype(np.uint8),
               np.full((H // 2, W // 2), 120 + t, np.uint8),
               np.full((H // 2, W // 2), 131 - t, np.uint8)]
              for t in range(3)]
    enc = Encoder(EncoderConfig(width=W, height=H, **settings))
    recon = []
    encode_frame = enc._encode_frame

    def keep(*a):
        out = encode_frame(*a)
        recon.append([p.copy() for p in enc.recon])
        return out
    enc._encode_frame = keep
    data = enc.encode(frames)
    kw = {"tile_devices": ["cuda:0"] * 2} if "tiles" in settings else {}
    st = {}
    pics = decode_stream_native(data, device="cuda", stats=st, **kw)
    assert len(pics) == 3 and st["n_host_frames"] == 0
    for pic, rec in zip(pics, recon):
        for p, r in zip(pic.planes, rec):
            assert np.array_equal(np.asarray(p), r)


# the per-picture push path (parse="python") on the card: vector ->
# (manifest, hybrid frames, numpy host frames)
PUSH_PYTHON = {"p_mixed": ("manifest_inter.json", 0, 0),
               "b_mixed": ("manifest_inter.json", 0, 0),
               "p_cra": ("manifest_inter.json", 0, 0),
               "p_10bit": ("manifest_inter.json", 0, 0),
               "rext_422_104x72": ("manifest_rext.json", 0, 0),
               "rxt_cqo": ("manifest_rext_tools.json", 4, 0),
               "rxt_ccp_444": ("manifest_rext_tools.json", 0, 4)}


def _trace_tools():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import gen_torch_recovery_goldens
    return gen_torch_recovery_goldens


@pytest.mark.parametrize("name", sorted(PUSH_PYTHON))
def test_push_python_on_card(cuda, name):
    """new_decoder(device="cuda", parse="python") in 997-byte pushes:
    every picture MD5-equal to the manifest, the frames routed as the
    segment path routes them, none concealed, no warning; and the same
    record (pictures, pts, warnings, statuses) as on the CPU."""
    from libde265_tpu_torch import api
    g = _trace_tools()
    manifest, nhyb, nhost = PUSH_PYTHON[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    rec, dec = g.trace(api, data, 997, device="cuda", parse="python")
    with open(os.path.join(DATA, manifest)) as f:
        m = json.load(f)[name]
    assert [p[1] for p in rec["pictures"]] == \
        [[f[k] for k in ("y", "u", "v")] for f in m["md5"]]
    st = dec.stats
    assert (st["n_hybrid_frames"], st["n_host_frames"],
            st["n_concealed_frames"]) == (nhyb, nhost, 0)
    assert not rec["warnings"]
    cpu, _ = g.trace(api, data, 997, device="cpu", parse="python")
    assert rec == cpu


def _recovery_cases():
    with open(os.path.join(DATA, "manifest_torch_recovery.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_recovery_cases()))
def test_recovery_goldens_on_card(cuda, name):
    """The recovery cases on the card equal the JAX decoder's goldens
    (tools/gen_torch_recovery_goldens.py); the fuzzed p_slices2 streams
    also through the default path's hand-off."""
    from libde265_tpu_torch import api
    g = _trace_tools()
    e = _recovery_cases()[name]
    r = e["recipe"]
    data = g.build_stream(r)
    rec, _ = g.trace(api, data, r["chunk"], r.get("dpb_size"),
                     device="cuda", parse="python")
    assert json.loads(json.dumps(rec)) == e["jax"]
    if r["native"]:
        nat, dec = g.trace(api, data, r["chunk"], device="cuda")
        for k in ("pictures", "warnings", "hash_checks"):
            assert json.loads(json.dumps(nat[k])) == e["jax"][k], k
        assert dec.stats["n_python_segments"] == 1


@pytest.mark.parametrize("parse", ["python", "native"])
def test_sps_bit_depth_above_16_refused_on_card(cuda, parse):
    """The fuzz file with a 25-bit luma SPS on the card: the SPS refused
    (SPS_HEADER_INVALID first), the same record as on the CPU."""
    from libde265_tpu_torch import api
    from libde265_tpu_torch.errors import Warning as W
    g = _trace_tools()
    with open(os.path.join(DATA, "id_009_intra_104x72_q26_flip2.bin"),
              "rb") as f:
        data = f.read()
    rec, _ = g.trace(api, data, 997, device="cuda", parse=parse)
    cpu, _ = g.trace(api, data, 997, device="cpu", parse=parse)
    assert rec == cpu
    assert rec["warnings"][:1] == [int(W.SPS_HEADER_INVALID)]


def _tools_golden():
    with open(os.path.join(DATA, "manifest_torch_tools.json")) as f:
        return json.load(f)


def _gen_tools():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import gen_torch_tools_goldens
    return gen_torch_tools_goldens


def _run_tool(name, argv, monkeypatch):
    """(exit code, stdout) of libde265_tpu_torch.tools.<name>.main; the
    kill-switch environment it sets is undone after the test."""
    import contextlib
    import importlib
    import io
    for k in ("DE265_DISABLE_DEBLOCK", "DE265_DISABLE_SAO"):
        monkeypatch.delenv(k, raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(
            f"libde265_tpu_torch.tools.{name}").main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("name,which", [
    (n, w) for n in sorted(_tools_golden()["killswitch"])
    for w in ("deblock", "sao", "both")])
def test_dec265_kill_switches_on_card(cuda, name, which, tmp_path,
                                      monkeypatch):
    """dec265 --disable-deblocking / --disable-sao / both on the card:
    every frame equal to the JAX tool's (tests/data/
    manifest_torch_tools.json), no K3 launch while SAO is off."""
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    g = _gen_tools()
    out = tmp_path / "out.yuv"
    sao_ctb.launches = 0
    rc, so = _run_tool("dec265", [*g.SWITCHES[which], "--device", "cuda",
                                  "-o", str(out),
                                  os.path.join(DATA, name + ".bin")],
                       monkeypatch)
    torch.cuda.synchronize()
    assert rc == 0
    assert g.frame_md5s(out.read_bytes(), g.n_frames(so)) == \
        _tools_golden()["killswitch"][name][which]
    if which != "deblock":
        assert sao_ctb.launches == 0


@pytest.mark.parametrize("name", _tools_golden()["hash_sei"])
def test_dec265_hash_check_on_card(cuda, name, monkeypatch):
    rc, so = _run_tool("dec265", ["-c", "--device", "cuda",
                                  os.path.join(DATA, name + ".bin")],
                       monkeypatch)
    assert rc == 0 and "MISMATCH" not in so


def test_sherlock_and_seeded_tools_on_card(cuda, tmp_path, monkeypatch):
    """sherlock's layer pixels, and rd_curves' points (decoded on the
    card) on the seeded YUV, equal the JAX tools'."""
    g = _gen_tools()
    gold = _tools_golden()
    sg = gold["sherlock"]
    html = tmp_path / "s.html"
    rc, _ = _run_tool("sherlock", [
        os.path.join(DATA, sg["stream"] + ".bin"), "-o", str(html), "-n",
        str(sg["frames"]), "--device", "cuda"], monkeypatch)
    assert rc == 0
    imgs, meta = g.html_images(html.read_text())
    assert meta == sg["meta"]
    for d, want in zip(imgs, sg["pixels"]):
        for k, png in d.items():
            assert g.pixel_md5(g.filter0_pixels(png)) == want[k], k
    sd = gold["seeded"]
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(g.tools_yuv(sd["seed"], sd["w"], sd["h"], sd["frames"]))
    path = tmp_path / "a.json"
    rc, _ = _run_tool("rd_curves", [
        "-i", str(yuv), "-w", str(sd["w"]), "-h", str(sd["h"]), "-f",
        str(sd["rd_curves"]["a"]["frames"]), "--qps",
        sd["rd_curves"]["qps"], "-o", str(path), "--device", "cuda"],
        monkeypatch)
    assert rc == 0
    assert json.loads(path.read_text()) == sd["rd_curves"]["a"]["points"]


def test_acceleration_speed_on_card(cuda, monkeypatch):
    rc, so = _run_tool("acceleration_speed", ["--time", "--device", "cuda"],
                       monkeypatch)
    assert rc == 0 and so.splitlines()[-1] == \
        "all kernels verified against scalar reference"
    assert so.count("(CUDA events)") == 8


# ---- the measurement tools (libde265_tpu_torch/tools/bench*.py,
# profile_*.py) and the frame program's stages on the card

_STAGE_SETS = [(), ("tables",), ("mc", "mc_luma_only"), ("mc",),
               ("mc", "res"), ("mc", "res", "dbk"),
               ("mc", "res", "dbk", "sao", "tables")]


@pytest.mark.parametrize("stages", _STAGE_SETS, ids=lambda s: "-".join(s))
def test_stages_on_card(cuda, stages):
    """decode_frame_device(stages=...) on p_mv's first P frame on the
    card against the CPU (the kernels' plain versions), from the same
    seeded state: identical DPB stacks and tile tables, and K1 / K2 / K3
    launched only for the stages that run them."""
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import (decode_frame_device,
                                                  init_tables)
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    from libde265_tpu_torch.packing import REF_SLOTS, pack_frame, stream_cfg
    plans = _plans("p_mv")
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    t = pack_frame(plans[1], cfg, {plans[0].frame_id: 2,
                                   plans[1].frame_id: 6})
    rng = np.random.RandomState(3)
    H, W = cfg.H, cfg.W
    init = [rng.randint(0, 256, s).astype(np.int16) for s in (
        (REF_SLOTS, H, W), (REF_SLOTS, H // 2, W // 2),
        (REF_SLOTS, H // 2, W // 2))]
    init += [rng.randint(0, 256, tuple(a.shape)).astype(np.uint8)
             for a in init_tables(cfg, "cpu")]
    counters = (update_tile_table, mc_predict, sao_ctb)
    outs = []
    for dev in ("cpu", cuda):
        for f in counters:
            f.launches = 0
        state = [torch.from_numpy(a).to(dev) for a in init]
        outs.append(decode_frame_device(*state, plan_from_numpy(t, dev), 6,
                                        cfg, stages=stages))
        torch.cuda.synchronize()
        ln = [f.launches for f in counters]
    assert ln == [2 * ("tables" in stages),
                  ("mc" in stages) * (1 if "mc_luma_only" in stages else 2),
                  3 * ("sao" in stages and cfg.sao_enabled)]
    for a, b in zip(*outs):
        assert torch.equal(a, b.cpu())


def test_bench_tool_on_card(cuda, monkeypatch):
    """tools.bench on p_mv on the card (2 rounds): the MD5-checked round
    passes, every timed round launches K1 8, K2 6 and K4 2 (p_mv has no
    SAO: no K3)."""
    rc, so = _run_tool("bench", ["--stream", "p_mv", "--manifest",
                                 "manifest_inter.json", "--rounds", "2",
                                 "--device", "cuda"], monkeypatch)
    assert rc == 0
    res = json.loads(so.strip().splitlines()[-1])
    rounds = res["round_launches"]["serial"]
    assert len(rounds) == 2 and all(r == [8, 6, 0, 2, 0] for r in rounds)
    assert res["metric"] == "cuda_4k_e2e_decode_fps"
    assert res["device_busy_fps"] > 0 and res["device_busy_share"] > 0


def test_bench_intra_scan_on_card(cuda, monkeypatch):
    rc, so = _run_tool("bench_intra_scan", [
        "p_mv", "--fori", "--manifest", "manifest_inter.json", "--device",
        "cuda"], monkeypatch)
    assert rc == 0 and "MD5 MATCH" in so and "pictures EQUAL" in so


def test_full_pipeline_on_card_matches_cpu(cuda, monkeypatch):
    """The synthetic chain's checksum on the card equals the CPU's."""
    got = []
    for dev in ("cuda", "cpu"):
        rc, so = _run_tool("bench_full_pipeline", [
            "--iters", "2", "--height", "128", "--width", "256",
            "--device", dev], monkeypatch)
        assert rc == 0
        got.append(json.loads(so.strip().splitlines()[-1])["checksum"])
    assert got[0] == got[1]


@pytest.mark.parametrize("name,argv", [
    ("profile_frame_stages", ["p_mv", "--manifest", "manifest_inter.json",
                              "--rounds", "1"]),
    ("profile_intra", ["p_mv", "--reps", "1"]),
    ("bench_gop_device", ["--stream", "p_mv", "--manifest",
                          "manifest_inter.json"]),
    ("bench_e2e", [os.path.join(DATA, "p_mv.bin"), "device", "1"]),
])
def test_measurement_tool_on_card(cuda, monkeypatch, name, argv):
    rc, so = _run_tool(name, [*argv, "--device", "cuda"], monkeypatch)
    assert rc == 0, so
