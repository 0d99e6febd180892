"""The port's ops (libde265_tpu_torch/ops) against the JAX package's on
identical seeded inputs, with exact equality (the decode is integer).
Kernel modules run their plain PyTorch versions here (CPU tensors); the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do."""
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")


def _eq(a, b, what=""):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if not np.array_equal(a, b):
        bad = np.argwhere(a != b)
        raise AssertionError(f"{what}: {len(bad)} mismatches, first at "
                             f"{bad[0]}: {a[tuple(bad[0])]} vs "
                             f"{b[tuple(bad[0])]}")


@pytest.mark.parametrize("log2,is_dst", [(2, True), (2, False), (3, False),
                                         (4, False), (5, False)])
def test_residual_batch(log2, is_dst):
    import jax.numpy as jnp
    from libde265_tpu.ops import transform_jax as J
    from libde265_tpu_torch.ops import transform as P
    rng = np.random.RandomState(10 + log2)
    n = 1 << log2
    N = 24
    # levels and QPs with |coeff * factor| < 2^31, so the JAX int32 dequant
    # does not wrap
    c = rng.randint(-300, 301, (N, n, n)).astype(np.int32)
    c[rng.rand(N, n, n) < 0.6] = 0
    qp = rng.randint(0, 40, N).astype(np.int32)
    want = J.residual_batch(jnp.asarray(c), jnp.asarray(qp), log2, is_dst, 8)
    got = P.residual_batch(torch.as_tensor(c), torch.as_tensor(qp), log2,
                           is_dst, 8)
    _eq(got, want, "residual_batch")
    d = J.dequant_batch(jnp.asarray(c), jnp.asarray(qp), log2, 8)
    _eq(P.dequant_batch(torch.as_tensor(c), torch.as_tensor(qp), log2, 8),
        d, "dequant_batch")
    # transform skip: the spec's 5 + log2 shift of the numpy reference at
    # every size; the JAX function shifts by 7 (4x4's) at every size, so
    # it is the reference at 4x4 only (ROADMAP queue 3)
    from libde265_tpu.ops.transform_ref import transform_skip_residual
    got = P.transform_skip_batch(torch.as_tensor(np.asarray(d)), log2, 8)
    _eq(got, np.stack([transform_skip_residual(b, log2, 8)
                       for b in np.asarray(d)]), "transform_skip_batch")
    if log2 == 2:
        _eq(got, J.transform_skip_batch(d, log2, 8), "transform_skip_batch")


def _planes(rng, H, W):
    return (rng.randint(0, 256, (H, W)).astype(np.int16),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.int16),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.int16))


def test_build_tile_tables():
    import jax.numpy as jnp
    from libde265_tpu.ops import mc_tile_jax as J
    from libde265_tpu_torch.ops import mc_tile as P
    rng = np.random.RandomState(3)
    Y, Cb, _ = _planes(rng, 40, 72)
    for pad, f_j, f_p, plane in ((16, J.build_tile_table_y,
                                  P.build_tile_table_y, Y),
                                 (8, J.build_tile_table_c,
                                  P.build_tile_table_c, Cb)):
        pj = J.pad_plane(jnp.asarray(plane), pad)
        pp = P.pad_plane(torch.as_tensor(plane), pad)
        _eq(pp, pj, "pad_plane")
        _eq(f_p(pp[None], torch.uint8), f_j(pj[None], jnp.uint8), "build")


def test_tile_table_update_k1():
    """K1 (plain version on CPU) against update_tile_table_pallas in
    interpret mode: equal on every valid row of the written slot, other
    slots untouched (tests/test_mc_tile.py:233-270)."""
    _k1_vs_pallas(72, 136, 4, 2)


@pytest.mark.parametrize("H,W,NS,slot", [(64, 304, 4, 3), (16, 16, 2, 1)])
def test_tile_table_update_k1_last_slot(H, W, NS, slot):
    """The same into the last slot: at 64x304 (81 luma / 41 chroma tile
    columns, no whole multiple of 64) and at 16x16 (8x8 chroma planes)."""
    _k1_vs_pallas(H, W, NS, slot)


def _k1_vs_pallas(H, W, NS, slot):
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import (PAD_Y, PAD_C, n_tiles_y,
                                              n_tiles_c)
    from libde265_tpu.ops.pallas.mc_tables import update_tile_table_pallas
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    rng = np.random.RandomState(7)
    Y, Cb, Cr = _planes(rng, H, W)
    for T, planes, pad, (ntyp, ntx), nty in (
            (16, [Y], PAD_Y, n_tiles_y(H, W), (H + 20) // 4),
            (8, [Cb, Cr], PAD_C, n_tiles_c(H // 2, W // 2),
             (H // 2 + 12) // 4)):
        P = len(planes)
        init = rng.randint(0, 256, (NS * ntyp * ntx, P * T * T)) \
            .astype(np.uint8)
        padded = np.stack([np.pad(p, pad, mode="edge") for p in planes])
        want = np.asarray(update_tile_table_pallas(
            jnp.asarray(init), jnp.asarray(padded), np.int32(slot), T,
            interpret=True)).reshape(NS, ntyp, ntx, -1)
        got = update_tile_table(torch.as_tensor(init),
                                torch.as_tensor(padded), slot, T)
        got = got.numpy().reshape(NS, ntyp, ntx, -1)
        _eq(got[slot, :nty], want[slot, :nty], f"K1 T={T} slot rows")
        assert not got[slot, nty:].any(), "layout rows are zeroed"
        others = [s for s in range(NS) if s != slot]
        _eq(got[others], init.reshape(NS, ntyp, ntx, -1)[others],
            f"K1 T={T} other slots")


@pytest.mark.parametrize("bi", [False, True])
def test_mc_frame_tile(bi):
    import jax.numpy as jnp
    from libde265_tpu.ops import mc_tile_jax as J
    from libde265_tpu_torch.ops import mc_tile as P
    rng = np.random.RandomState(20 + bi)
    H, W, R = 48, 80, 3
    refs = [np.stack([_planes(rng, H, W)[c] for _ in range(R)])
            for c in range(3)]
    ty, tc = J.build_tables(*(jnp.asarray(r) for r in refs), bitdepth=8)
    N = (H // 4) * (W // 4)
    mv = rng.randint(-90, 91, (N, 2, 2)).astype(np.int32)
    mv[rng.rand(N) < 0.1] = rng.randint(-900, 900, (2, 2))   # far out
    slot = rng.randint(0, R, (N, 2)).astype(np.int32)
    pf = np.stack([np.ones(N, np.int32),
                   (rng.rand(N) < 0.5).astype(np.int32) * bi], axis=1)
    want = J.mc_frame_tile((ty, tc), (H, W), jnp.asarray(mv),
                           jnp.asarray(slot), jnp.asarray(pf),
                           jnp.zeros((N, 3, 5), jnp.int32),
                           jnp.zeros((N,), bool), 8, bi=bi, weighted=False)
    args = ((H, W), torch.as_tensor(mv), torch.as_tensor(slot),
            torch.as_tensor(pf), None, None,
            torch.ones((H // 4, W // 4), dtype=torch.bool), 8, bi)
    got = P.mc_predict_plain(torch.as_tensor(np.asarray(ty)), *args) \
        + P.mc_predict_plain(torch.as_tensor(np.asarray(tc)), *args)
    for ci in range(3):
        _eq(got[ci], want[ci], f"mc plane {ci}")


def _luma_meta(rng, n_s, n_e):
    return [rng.randint(0, 3, (n_s, n_e)).astype(np.int32),
            rng.randint(10, 52, (n_s, n_e)).astype(np.int32),
            2 * rng.randint(-3, 4, (n_s, n_e)).astype(np.int32),
            2 * rng.randint(-3, 4, (n_s, n_e)).astype(np.int32),
            rng.rand(n_s, n_e) < 0.1, rng.rand(n_s, n_e) < 0.1]


@pytest.mark.parametrize("vertical", [True, False])
def test_deblock_passes(vertical):
    import jax.numpy as jnp
    from libde265_tpu.ops import deblock_jax as J
    from libde265_tpu_torch.ops import deblock as P
    rng = np.random.RandomState(30 + vertical)
    H, W = 64, 96
    # smooth-ish content so strong, weak and off decisions all occur
    Y = (np.cumsum(rng.randint(-3, 4, (H, W)), axis=1) + 128) \
        .clip(0, 255).astype(np.int32)
    n_s, n_e = (H // 4, W // 8 - 1) if vertical else (W // 4, H // 8 - 1)
    meta = _luma_meta(rng, n_s, n_e)
    want = J.deblock_luma_pass(jnp.asarray(Y),
                               *(jnp.asarray(m) for m in meta),
                               vertical=vertical, bitdepth=8)
    got = P.deblock_luma_pass(torch.as_tensor(Y),
                              *(torch.as_tensor(m) for m in meta),
                              vertical=vertical, bitdepth=8)
    _eq(got, want, "deblock luma")
    C = Y[:H // 2, :W // 2].copy()
    We = W if vertical else H       # luma extent across the edges
    n_s = H // 4 if vertical else W // 4
    n_e = We // 16 - (1 if We % 16 == 0 else 0)
    act = rng.rand(n_s, n_e) < 0.7
    tc = rng.randint(0, 8, (n_s, n_e)).astype(np.int32)
    po, qo = rng.rand(n_s, n_e) < 0.1, rng.rand(n_s, n_e) < 0.1
    want = J.deblock_chroma_pass(jnp.asarray(C), *(jnp.asarray(m) for m in
                                                   (act, tc, po, qo)),
                                 vertical=vertical, bitdepth=8)
    got = P.deblock_chroma_pass(torch.as_tensor(C),
                                *(torch.as_tensor(m) for m in
                                  (act, tc, po, qo)),
                                vertical=vertical, bitdepth=8)
    _eq(got, want, "deblock chroma")


def _grids(rng, nctby, nctbx, S1, gh, gw):
    # picture-boundary neighbour pairs are never available (the host
    # planners guarantee it; tests/test_sao_pallas.py)
    pair_ok = rng.rand(4, nctby, nctbx) < 0.8
    pair_ok[0, :, 0] = False
    pair_ok[1, :, -1] = False
    pair_ok[2, 0, :] = False
    pair_ok[3, -1, :] = False
    return {
        "sao_type": rng.randint(0, 3, (nctby, nctbx, 3)).astype(np.uint8),
        "sao_eo": rng.randint(0, 4, (nctby, nctbx, 3)).astype(np.uint8),
        "sao_band": rng.randint(0, 32, (nctby, nctbx, 3)).astype(np.uint8),
        "sao_off": rng.randint(-7, 8, (nctby, nctbx, 3, 4)).astype(np.int16),
        "sidx": rng.randint(0, S1, (nctby, nctbx)).astype(np.int32),
        "sh_sao_luma": rng.randint(0, 2, S1).astype(np.int32),
        "sh_sao_chroma": rng.randint(0, 2, S1).astype(np.int32),
        "off": (rng.rand(gh, gw) < 0.05).astype(np.uint8),
        "pair_ok": pair_ok,
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_sao_planner_and_k3(seed):
    """plan_sao_compact and K3 (plain version on CPU) against the JAX
    planner, sao_pallas in interpret mode and the XLA sao_apply."""
    import jax.numpy as jnp
    from libde265_tpu.ops import filter_plan_jax as FJ
    from libde265_tpu.ops.sao_jax import sao_apply
    from libde265_tpu.ops.pallas.sao_filter import sao_pallas
    from libde265_tpu_torch.ops import filter_plan as FP
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_filter_plain
    rng = np.random.RandomState(seed)
    nctby, nctbx, S1 = 3, 4, 4
    H, W = nctby * 64 - 16, nctbx * 64
    g = _grids(rng, nctby, nctbx, S1, H // 4, W // 4)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gp = {k: torch.as_tensor(v) for k, v in g.items()}
    cfg_s = (6, 1, H, W, 2, 2)
    for ci in range(3):
        sub = 1 if ci == 0 else 2
        x = rng.randint(0, 256, (H // sub, W // sub)).astype(np.int32)
        mj = FJ.plan_sao_compact(gj, cfg_s, ci)
        mp = FP.plan_sao_compact(gp, cfg_s, ci)
        for a, b, what in zip(mp, mj, ("mode", "aux", "offs")):
            _eq(a, b, f"plan_sao_compact {what} plane {ci}")
        got = sao_filter_plain(torch.as_tensor(x),
                               *(m.contiguous() for m in mp), bitdepth=8)
        _eq(got, sao_pallas(jnp.asarray(x), *mj, bitdepth=8,
                            interpret=True), f"K3 vs sao_pallas {ci}")
        _eq(got, sao_apply(jnp.asarray(x), *FJ.plan_sao_device(
            gj, cfg_s, ci), bitdepth=8), f"K3 vs sao_apply {ci}")


def _sao_case(seed, ci, xoff, bitdepth, W=None):
    """Seeded inputs of K3 for plane ci: a picture of 3x4 64x64 CTBs cut to
    176 x W (default 240: the last CTB row and column partial), 4 slice
    rows (row 0 with SAO off for luma, row 1 on for both), random
    pcm/tq-bypass blocks and one CTB that is bypass everywhere (an edge
    CTB of slice row 1). xoff = 0: the whole frame; otherwise the
    halo-extended strip of a tile column 128 luma samples wide whose first
    column sits at global luma x = xoff (the strip-local off grid).
    Returns (x (Hs, Ws) int32, numpy grids, scfg)."""
    rng = np.random.RandomState(seed)
    nctby, nctbx, S1 = 3, 4, 4
    H, W = nctby * 64 - 16, W or nctbx * 64 - 16
    ws = W if xoff == 0 else 128 + 32
    g = _grids(rng, nctby, nctbx, S1, H // 4, ws // 4)
    g["sh_sao_luma"][:2] = (0, 1)
    g["sh_sao_chroma"][:2] = (1, 1)
    cx = max(xoff, 0) // 64 + 1
    j0 = (64 * cx - xoff) // 4
    g["off"][16:32, j0:j0 + 16] = 1
    g["sidx"][1, cx] = 1
    g["sao_type"][1, cx, :] = 2
    sub = 1 if ci == 0 else 2
    x = rng.randint(0, 1 << bitdepth, (H // sub, ws // sub)).astype(np.int32)
    return x, g, (6, 1, H, W, 2, 2)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("xoff", [0, -16, 112])
@pytest.mark.parametrize("ci", [0, 1, 2])
def test_sao_ctb_plain_matches_jax(ci, xoff, bitdepth):
    """K3's new contract on the CPU: sao_ctb (its plain version here,
    plan_sao_compact + sao_filter_plain) against the JAX plan_sao_compact
    + sao_pallas in interpret mode and plan_sao_device + sao_apply, exact.
    xoff = -16 is the first strip of a tile column (halo left of the
    picture), 112 a strip that runs past the picture's partial last CTB
    column; neither is a multiple of the CTB width. In a strip, the
    plane's outermost columns are halo that the decoder crops, and their
    edge-offset neighbours lie outside the plane: the port reads them
    clamped, sao_pallas wrapped and sao_apply zero-padded, so those two
    columns are left out of the comparison for xoff != 0."""
    import jax.numpy as jnp
    from libde265_tpu.ops import filter_plan_jax as FJ
    from libde265_tpu.ops.pallas.sao_filter import sao_pallas
    from libde265_tpu.ops.sao_jax import sao_apply
    from libde265_tpu_torch.ops.kernels.sao_filter import (sao_ctb,
                                                           sao_ctb_plain)
    x, g, cfg = _sao_case(100 * ci + bitdepth, ci, xoff, bitdepth)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gp = {k: torch.as_tensor(v) for k, v in g.items()}
    n = sao_ctb.launches
    got = sao_ctb(torch.as_tensor(x), gp, cfg, ci, xoff, bitdepth)
    assert sao_ctb.launches == n
    _eq(got, sao_ctb_plain(torch.as_tensor(x), gp, cfg, ci, xoff, bitdepth),
        "sao_ctb vs sao_ctb_plain")
    cols = slice(None) if xoff == 0 else slice(1, -1)
    xj = jnp.asarray(x)
    want = sao_pallas(xj, *FJ.plan_sao_compact(gj, cfg, ci, xoff),
                      bitdepth=bitdepth, interpret=True)
    _eq(got[:, cols], np.asarray(want)[:, cols], "K3 vs sao_pallas")
    want = sao_apply(xj, *FJ.plan_sao_device(gj, cfg, ci, xoff),
                     bitdepth=bitdepth)
    _eq(got[:, cols], np.asarray(want)[:, cols], "K3 vs sao_apply")
    assert not np.array_equal(got.numpy(), x)      # SAO changed samples


@pytest.mark.parametrize("name", ["p_deblk", "b_mv", "p_cif_mixed"])
def test_deblock_planner_on_stream(name):
    """plan_deblock_device on real packed grids (expanded as the frame
    program does) against the JAX planner."""
    import jax.numpy as jnp
    from libde265_tpu.ops import filter_plan_jax as FJ
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids
    from libde265_tpu_torch.ops import filter_plan as FP
    from libde265_tpu_torch.packing import (REF_SLOTS, frame_has_intra,
                                            pack_frame, stream_cfg)
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = _parse(f.read())
    cfg = stream_cfg(plans, plans[0].sps)
    fid_slot = {p.frame_id: i % REF_SLOTS for i, p in enumerate(plans)}
    for plan in plans[1:]:
        if frame_has_intra(plan) and not cfg.intra:
            continue
        t = frame_grids(plan_from_numpy(pack_frame(plan, cfg, fid_slot),
                                        "cpu"), cfg)
        lm_p, cm_p = FP.plan_deblock_device(t, cfg.fcfg)
        tj = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
        lm_j, cm_j = FJ.plan_deblock_device(tj, cfg.fcfg)
        for a, b in zip(lm_p + cm_p, lm_j + cm_j):
            for x, y in zip(a, b):
                _eq(x, y, "deblock planner")
