"""K2's plain version (libde265_tpu_torch.ops.mc_tile.mc_predict_plain)
against the JAX package's MC on identical seeded inputs, exact equality:
the tile-table MC through the Pallas tap kernel (mc_frame_tile with
use_pallas=True, interpret mode on the CPU as tests/test_mc_tile.py runs
it) and the dense window-gather MC (inter_dense_jax.mc_dense). Uni, bi
and explicit weighted prediction; uint8 tables for 8-bit and int16
tables for 10-bit; MVs up to +-2^14 reach the edge clamp. The JAX
outputs are dense, so they are masked with the same inter mask here."""
import numpy as np
import pytest
import torch

H, W, R = 64, 128, 4


def _case(seed, bitdepth, bi, weighted, Wo=W):
    """Seeded references of (H, W) and grids for the N blocks of an
    (H, Wo) output."""
    rng = np.random.RandomState(seed)
    maxv = (1 << bitdepth) - 1
    refs = [rng.randint(0, maxv + 1, (R, h, w)).astype(np.int32)
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    N = (H // 4) * (Wo // 4)
    mv = rng.randint(-(1 << 14), 1 << 14, (N, 2, 2)).astype(np.int32)
    near = rng.rand(N) < 0.5                 # half the blocks stay inside
    mv[near] = rng.randint(-64, 64, (int(near.sum()), 2, 2))
    slot = rng.randint(0, R, (N, 2)).astype(np.int32)
    pf = np.stack([np.ones(N, np.int32),
                   rng.randint(0, 2, N).astype(np.int32) * bi], axis=1)
    wts = np.zeros((N, 3, 5), np.int32)
    ex = np.zeros(N, bool)
    if weighted:
        ex[:] = rng.rand(N) < 0.7
        wts[:, :, 4] = rng.randint(0, 8, (N, 3)) + 14 - bitdepth
        wts[:, :, 0] = rng.randint(-128, 128, (N, 3))
        wts[:, :, 2] = rng.randint(-128, 128, (N, 3))
        wts[:, :, 1] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
        wts[:, :, 3] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
    inter = rng.rand(H // 4, Wo // 4) < 0.8
    return refs, mv, slot, pf, wts, ex, inter


def _tables(refs, bitdepth):
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import build_tables
    return build_tables(*(jnp.asarray(r) for r in refs), bitdepth=bitdepth)


def _masked(planes, inter):
    out = []
    for ci, p in enumerate(planes):
        f = 4 if ci == 0 else 2
        out.append(np.asarray(p) * np.kron(inter, np.ones((f, f), bool)))
    return out


def _port(tabs, mv, slot, pf, wts, ex, inter, bitdepth, bi, weighted,
          fn=None, **strip):
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    fn = fn or mc_predict_plain
    w = (torch.as_tensor(wts), torch.as_tensor(ex.astype(np.int32))) \
        if weighted else (None, None)
    args = ((H, W), torch.as_tensor(mv), torch.as_tensor(slot),
            torch.as_tensor(pf), *w, torch.as_tensor(inter), bitdepth, bi)
    ty, tc = (torch.as_tensor(np.asarray(t)) for t in tabs)
    return [p.numpy() for p in fn(ty, *args, **strip)
            + fn(tc, *args, **strip)]


def _eq(got, want, what):
    for ci, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, ci)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)
            raise AssertionError(f"{what} plane {ci}: {len(bad)} mismatches, "
                                 f"first at {bad[0]}: {a[tuple(bad[0])]} vs "
                                 f"{b[tuple(bad[0])]}")


@pytest.mark.parametrize("seed,bitdepth,bi", [(0, 8, False), (1, 8, True),
                                              (2, 10, False), (3, 10, True),
                                              (8, 12, False)])
def test_mc_predict_plain_matches_pallas_k2(seed, bitdepth, bi):
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import mc_frame_tile
    refs, mv, slot, pf, wts, ex, inter = _case(seed, bitdepth, bi, False)
    tabs = _tables(refs, bitdepth)
    assert np.asarray(tabs[0]).dtype == (np.uint8 if bitdepth == 8
                                         else np.int16)
    want = mc_frame_tile(tabs, (H, W), jnp.asarray(mv), jnp.asarray(slot),
                         jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex),
                         bitdepth, bi=bi, use_pallas=True, weighted=False)
    got = _port(tabs, mv, slot, pf, wts, ex, inter, bitdepth, bi, False)
    _eq(got, _masked(want, inter), "pallas K2")


@pytest.mark.parametrize("seed,bitdepth,bi", [(4, 8, True), (5, 8, False),
                                              (6, 10, True)])
def test_mc_predict_plain_weighted(seed, bitdepth, bi):
    import jax.numpy as jnp
    from libde265_tpu.ops.inter_dense_jax import mc_dense
    from libde265_tpu.ops.mc_tile_jax import mc_frame_tile
    refs, mv, slot, pf, wts, ex, inter = _case(seed, bitdepth, bi, True)
    tabs = _tables(refs, bitdepth)
    jargs = [jnp.asarray(a) for a in (mv, slot, pf, wts, ex)]
    got = _port(tabs, mv, slot, pf, wts, ex, inter, bitdepth, bi, True)
    want = mc_frame_tile(tabs, (H, W), *jargs, bitdepth, bi=bi,
                         use_pallas=True, weighted=True)
    _eq(got, _masked(want, inter), "pallas K2, weighted")
    dense = mc_dense(*(jnp.asarray(r) for r in refs), *jargs, bitdepth)
    _eq(got, _masked(dense, inter), "mc_dense, weighted")


@pytest.mark.parametrize("x0,Ws,bitdepth,bi", [(64, 64, 8, False),
                                               (96, 64, 10, True),
                                               (64, 64, 12, True)])
def test_mc_predict_plain_strip_matches_pallas_k2(x0, Ws, bitdepth, bi):
    """The strip form (the tile-column decoder's) at the right edge: a
    strip at the last column (x0 = 64 of 128) and one that runs past the
    frame's right edge (x0 = 96), against mc_frame_tile(strip=, x0=)
    through the Pallas tap kernel."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import mc_frame_tile
    refs, mv, slot, pf, wts, ex, inter = _case(20 + x0 + bitdepth, bitdepth,
                                               bi, True, Wo=Ws)
    tabs = _tables(refs, bitdepth)
    want = mc_frame_tile(tabs, (H, W), jnp.asarray(mv), jnp.asarray(slot),
                         jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex),
                         bitdepth, strip=Ws, x0=x0, bi=bi, use_pallas=True,
                         weighted=True)
    got = _port(tabs, mv, slot, pf, wts, ex, inter, bitdepth, bi, True,
                strip=Ws, x0=x0)
    _eq(got, _masked(want, inter), "pallas K2, strip")


@pytest.mark.parametrize("weighted", [False, True])
def test_mc_predict_cpu_wrapper_is_plain(weighted):
    """On CPU tensors the K2 wrapper runs the plain version and launches
    nothing."""
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    refs, mv, slot, pf, wts, ex, inter = _case(7, 8, True, weighted)
    tabs = _tables(refs, 8)
    n = mc_predict.launches
    got = _port(tabs, mv, slot, pf, wts, ex, inter, 8, True, weighted,
                fn=mc_predict)
    want = _port(tabs, mv, slot, pf, wts, ex, inter, 8, True, weighted)
    _eq(got, want, "wrapper")
    assert mc_predict.launches == n
