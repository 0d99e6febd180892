"""The port's tile mesh demo (libde265_tpu_torch/parallel/tile_mesh.py:
column shards on a list of devices, seam columns copied device to device,
an int64 checksum summed on devices[0]) against the JAX one
(libde265_tpu/parallel/tile_mesh.py, shard_map over 2 and 4 devices of
the virtual CPU mesh of tests/conftest.py): the filtered plane exactly
and the checksum equal."""
import numpy as np
import pytest
import torch


def _jax_step(H, W, tiles, n_tu, bitdepth=8):
    import jax
    from jax.sharding import Mesh
    from libde265_tpu.parallel.tile_mesh import make_tile_recon_step
    mesh = Mesh(np.array(jax.devices()[:tiles]), ("tile",))
    return make_tile_recon_step(mesh, H, W, tiles, n_tu, bitdepth=bitdepth)


def _distinct(inp, tiles, n=16):
    """demo inputs with the TU positions of each shard made distinct."""
    plane, coeffs, qp, xs, ys = (a.copy() for a in inp)
    H, W = plane.shape
    nb, bw = len(xs) // tiles, W // tiles // n
    rng = np.random.RandomState(1)
    for d in range(tiles):
        k = rng.choice(bw * (H // n), nb, replace=False)
        xs[d * nb:(d + 1) * nb] = (k % bw) * n
        ys[d * nb:(d + 1) * nb] = (k // bw) * n
    return plane, coeffs, qp, xs, ys


def _duplicates(xs, ys, tiles):
    nb = len(xs) // tiles
    return [nb - len(set(zip(xs[d * nb:(d + 1) * nb], ys[d * nb:(d + 1) * nb])))
            for d in range(tiles)]


@pytest.mark.parametrize("tiles", [2, 4])
@pytest.mark.parametrize("inputs", ["demo", "distinct"])
def test_tile_mesh_matches_jax(tiles, inputs):
    from libde265_tpu_torch.parallel import tile_mesh as P
    H, W, n_tu = 64, 128, 16
    inp = P.demo_inputs(H, W, tiles, n_tu)
    if inputs == "distinct":
        inp = _distinct(inp, tiles)
        assert _duplicates(inp[3], inp[4], tiles) == [0] * tiles
    want, wsum = _jax_step(H, W, tiles, n_tu)(*inp)
    got, gsum = P.make_tile_recon_step(["cpu"] * tiles, H, W, tiles,
                                       n_tu)(*inp)
    assert got.dtype == torch.int32 and gsum.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert gsum.tolist() == np.asarray(wsum).tolist()
    assert int(gsum) == int(got.numpy().astype(np.int64).sum())


def test_demo_inputs_match_jax_and_hold_duplicates():
    """The same RandomState draws as the JAX demo; with (64, 128, 2, 16)
    shard 0 draws two TUs onto blocks already taken (the case where the
    JAX scatter's order is XLA's)."""
    from libde265_tpu.parallel import tile_mesh as J
    from libde265_tpu_torch.parallel import tile_mesh as P
    for args in ((64, 128, 2, 16), (48, 96, 4, 40), (32, 64, 2, 8, 3, 5)):
        for a, b in zip(P.demo_inputs(*args), J.demo_inputs(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    _, _, _, xs, ys = P.demo_inputs(64, 128, 2, 16)
    assert _duplicates(xs, ys, 2) == [2, 0]


def test_tile_mesh_last_tu_wins():
    """TUs on the same block apply in batch order: the later one's
    residual wins, whatever the device."""
    from libde265_tpu_torch.parallel import tile_mesh as P
    H, W, tiles, n_tu = 32, 64, 2, 8
    plane, coeffs, qp, xs, ys = _distinct(
        P.demo_inputs(H, W, tiles, n_tu), tiles)
    xs[2], ys[2] = xs[0], ys[0]           # TU 2 lands on TU 0's block
    step = P.make_tile_recon_step(["cpu"] * tiles, H, W, tiles, n_tu)
    got = step(plane, coeffs, qp, xs, ys)[0]
    later, earlier = coeffs.copy(), coeffs.copy()
    later[0] = coeffs[2]
    earlier[2] = coeffs[0]
    assert torch.equal(got, step(plane, later, qp, xs, ys)[0])
    assert not torch.equal(got, step(plane, earlier, qp, xs, ys)[0])


def test_tile_mesh_device_list_forms():
    """The device list may repeat one device, given as strings or torch
    devices, and the inputs may be tensors; the output lies on
    devices[0]."""
    from libde265_tpu_torch.parallel import tile_mesh as P
    H, W, tiles, n_tu = 32, 64, 4, 8
    inp = P.demo_inputs(H, W, tiles, n_tu)
    a = P.make_tile_recon_step(["cpu"] * tiles, H, W, tiles, n_tu)(*inp)
    b = P.make_tile_recon_step([torch.device("cpu")] * tiles, H, W, tiles,
                               n_tu)(*(torch.as_tensor(x) for x in inp))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert b[0].device == torch.device("cpu")


def test_tile_mesh_checksum_is_int64():
    """A 12-bit plane whose sum passes 2^31: the checksum does not wrap
    (the JAX one is an int32 sum: ROADMAP queue 3)."""
    from libde265_tpu_torch.parallel import tile_mesh as P
    H, W, tiles, n_tu = 1024, 1024, 2, 2
    plane = np.full((H, W), 4095, np.int32)
    coeffs = np.zeros((n_tu, 16, 16), np.int32)
    z = np.zeros(n_tu, np.int32)
    out, s = P.make_tile_recon_step(["cpu"] * tiles, H, W, tiles, n_tu,
                                    bitdepth=12)(plane, coeffs, z + 30, z, z)
    assert int(s) == int(out.numpy().astype(np.int64).sum()) > 2 ** 31


@pytest.mark.parametrize("devices,W,n_tu", [
    (["cpu"] * 3, 128, 16),        # 3 devices for 2 tiles
    (["cpu"] * 2, 128, 15),        # n_tu not a multiple of tiles
    (["cpu"] * 2, 127, 16),        # W not a multiple of tiles
])
def test_tile_mesh_rejects_bad_shapes(devices, W, n_tu):
    from libde265_tpu_torch.parallel.tile_mesh import make_tile_recon_step
    with pytest.raises(ValueError):
        make_tile_recon_step(devices, 64, W, 2, n_tu)
