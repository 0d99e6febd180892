"""The port's GOP-parallel decoder (libde265_tpu_torch/parallel/
gop_parallel.py, CPU tensors: the kernels' plain versions) against the
JAX package's (libde265_tpu/parallel/gop_parallel.py): the byte split,
the (poc, yuv) lists of the worker route (spawned processes here, forked
host workers there) and of the device route, exact; and the routing
rules (the GOP decoder first, the workers only where it refuses the
stream, every other error raised). One pool of two spawned workers
serves the whole file."""
import multiprocessing as mp
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


STREAMS = {"p_mixed2": lambda: _load("p_mixed") * 2,
           "rxt_cqo2": lambda: _load("rxt_cqo") * 2,
           "p_cra": lambda: _load("p_cra")}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX decode_gop_parallel's lists (backend="numpy", workers=2),
    made before the port runs anything in this process (its workers are
    forked)."""
    from libde265_tpu.parallel.gop_parallel import decode_gop_parallel
    return {(name, native): decode_gop_parallel(STREAMS[name](),
                                                workers=2, native=native,
                                                backend="numpy")
            for name in ("p_mixed2", "rxt_cqo2") for native in (True, False)}


@pytest.fixture(scope="module")
def pool():
    with mp.get_context("spawn").Pool(2) as p:
        yield p


@pytest.mark.parametrize("name", ["p_mixed2", "p_cra"])
def test_split_gops_matches_jax(name):
    """Byte for byte the JAX split: at every IRAP (CRA included), each
    segment prefixed with the parameter sets; gop_shard keeps no copy."""
    from libde265_tpu.parallel.gop_parallel import split_gops as jax_split
    from libde265_tpu_torch.parallel import gop_parallel, gop_shard
    data = STREAMS[name]()
    got = gop_parallel.split_gops(data)
    assert got == jax_split(data) and len(got) >= 2
    assert gop_shard.split_gops is gop_parallel.split_gops


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["p_mixed2", "rxt_cqo2"])
def test_workers_match_jax(name, native, jax_ref, pool):
    """backend="workers" on ["cpu"]: each segment decoded in a spawned
    worker (decode_stream_native, or the push API with native=False), the
    same (poc, yuv) list as the JAX host workers; the hybrid frames of
    rxt_cqo counted in the workers' stats."""
    from libde265_tpu_torch.parallel.gop_parallel import decode_gop_parallel
    st = {}
    got = decode_gop_parallel(STREAMS[name](), backend="workers",
                              native=native, devices=["cpu"], stats=st,
                              pool=pool)
    assert got == jax_ref[(name, native)]
    assert (st["route"], st["n_gops"], st["n_frames"]) == ("workers", 2, 8)
    assert st["n_hybrid_frames"] == (8 if name == "rxt_cqo2" else 0)
    assert [s["device"] for s in st["per_gop"]] == ["cpu", "cpu"]


@pytest.mark.parametrize("name,route", [("p_mixed2", "device"),
                                        ("rxt_cqo2", "workers")])
def test_default_route(name, route, jax_ref, pool):
    """backend=None: the GOP decoder takes p_mixed twice over; it refuses
    rxt_cqo (TU-level chroma QP offsets: hybrid frames), which the
    workers then decode. The same lists as the JAX function."""
    from libde265_tpu_torch.parallel.gop_parallel import decode_gop_parallel
    st = {}
    got = decode_gop_parallel(STREAMS[name](), devices=["cpu", "cpu"],
                              stats=st, pool=pool)
    assert st["route"] == route
    assert got == jax_ref[(name, True)]


def test_other_errors_propagate(monkeypatch, pool):
    """An error of the GOP decoder other than its refusal is raised, not
    handed to the workers; a worker's error reaches the caller."""
    from libde265_tpu_torch.parallel import gop_parallel, gop_shard

    def broken(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(gop_shard, "decode_gops", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        gop_parallel.decode_gop_parallel(STREAMS["p_mixed2"](),
                                         devices=["cpu"], pool=pool)
    monkeypatch.undo()
    # the second IDR names PPS 4, which the stream does not have: the
    # parse of its worker fails
    data = bytearray(STREAMS["p_mixed2"]())
    sc = b"\x00\x00\x01\x26"                # an IDR_W_RADL NAL
    idr = data.index(sc, data.index(sc) + 1)
    assert data[idr + 5] == 0xAF          # first slice, pps id ue '1'
    data[idr + 5] = 0x8A                  # pps id ue '00101': 4
    with pytest.raises(ValueError, match="native front-end"):
        gop_parallel.decode_gop_parallel(bytes(data), backend="workers",
                                         devices=["cpu"], pool=pool)


def test_backend_names():
    """The JAX name of the worker route, "numpy", is refused with a
    ValueError that says what to use; "cuda" where no card is present
    raises before any work."""
    import torch
    from libde265_tpu_torch.parallel.gop_parallel import (
        decode_gop_device, decode_gop_parallel)
    with pytest.raises(ValueError, match="workers"):
        decode_gop_parallel(b"", backend="numpy", devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            decode_gop_parallel(STREAMS["p_mixed2"]())
        with pytest.raises(RuntimeError):
            decode_gop_device(STREAMS["p_mixed2"]())
