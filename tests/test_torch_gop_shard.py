"""The port's GOP-sharded decoder (libde265_tpu_torch/parallel/gop_shard.py,
CPU tensors: the kernels' plain versions) against the JAX package's
(libde265_tpu/parallel/gop_shard.py and gop_parallel.decode_gop_device on
the virtual CPU mesh of tests/conftest.py): the stream and plan split,
the pictures and their order, exact, and the GOPs it refuses."""
import os
import sys

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _stream(bit_depth):
    """64x64, 8 frames in closed GOPs of 3 (IDR + 2 P frames; the last
    GOP is an IDR and a P frame): mv + residual, deblocking and SAO."""
    sys.path.insert(0, TOOLS)
    from gen_inter_streams import make_frames
    from libde265_tpu.encoder import Encoder, EncoderConfig
    frames = make_frames(8, 64, 64)
    if bit_depth > 8:
        frames = [[(p.astype(np.uint16) << 2) | (p & 3) for p in f]
                  for f in frames]
    return Encoder(EncoderConfig(
        width=64, height=64, qp=30, bit_depth=bit_depth, inter_mode="mv",
        inter_residual=True, intra_period=3, disable_deblocking=False,
        sao=True)).encode(frames)


@pytest.fixture(scope="module")
def stream8():
    return _stream(8)


def test_split_matches_jax(stream8):
    """split_gops (bytes) and split_gop_plans (parsed plans) cut where the
    JAX package's do: 3 GOPs of 3, 3 and 2 frames, each on an IDR."""
    from libde265_tpu.parallel.gop_parallel import split_gops as jax_split
    from libde265_tpu.parallel.gop_shard import \
        split_gop_plans as jax_split_plans
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.parallel.gop_shard import (split_gop_plans,
                                                       split_gops)
    for data in (stream8, open(os.path.join(DATA, "gop1080p.bin"),
                               "rb").read()):
        assert split_gops(data) == jax_split(data)
    plans = _parse(stream8)
    got = [[p.frame_id for p in g] for g in split_gop_plans(plans)]
    want = [[p.frame_id for p in g] for g in jax_split_plans(plans)]
    assert got == want and [len(g) for g in got] == [3, 3, 2]
    assert all(g[0].nal_type in (19, 20) for g in split_gop_plans(plans))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_gop_decoder_matches_jax(bit_depth, stream8):
    """decode_stream_native(gop_devices=["cpu"] * 2): 3 GOPs over 2
    entries (two waves), the pictures in decode_gop_device's order (GOP
    by GOP, POC within a GOP) with byte-equal samples, and MD5-equal to
    the port's single-decoder decode of the same stream."""
    from libde265_tpu.parallel.gop_parallel import decode_gop_device
    from libde265_tpu_torch.api import decode_stream_native
    data = stream8 if bit_depth == 8 else _stream(bit_depth)
    st = {}
    got = decode_stream_native(data, stats=st, gop_devices=["cpu", "cpu"])
    assert (st["n_gops"], st["n_frames"], st["n_host_frames"]) == (3, 8, 0)
    want = decode_gop_device(data)
    assert [(g.poc, g.to_yuv_bytes()) for g in got] == want
    assert [g.poc for g in got] == [0, 1, 2, 0, 1, 2, 0, 1]
    assert got[0].planes[0].dtype == (np.uint8 if bit_depth == 8
                                      else np.uint16)
    single = decode_stream_native(data, device="cpu")
    assert [p.to_yuv_bytes() for p in single] == \
        [g.to_yuv_bytes() for g in got]


def test_gop_decoder_committed_streams():
    """p_mv twice over (two IDR GOPs of 4 frames) through one entry and
    through three: the manifest's MD5s for every frame."""
    import hashlib
    import json
    from libde265_tpu_torch.api import decode_stream_native
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        m = json.load(f)["p_mv"]
    data = open(os.path.join(DATA, "p_mv.bin"), "rb").read()
    for devs in (["cpu"], ["cpu"] * 3):
        pics = decode_stream_native(data * 2, gop_devices=devs)
        assert len(pics) == 2 * m["frames"]
        for i, pic in enumerate(pics):
            got = [hashlib.md5(np.ascontiguousarray(p).tobytes())
                   .hexdigest() for p in pic.planes]
            assert got == [m["md5"][i % m["frames"]][k]
                           for k in ("y", "u", "v")], (devs, i)


def test_gop_decoder_refusals(stream8):
    """ValueError, where the JAX function asserts, for a GOP that does
    not start with an IRAP, a frame frame_compatible rejects (the
    rotation frame of adv_rot_tsctx_wpp) and a frame referencing one
    outside its GOP (the second IDR dropped); an empty device list too."""
    from libde265_tpu_torch.api import _parse, decode_stream_native
    from libde265_tpu_torch.parallel.gop_shard import decode_gops
    plans = _parse(stream8)
    with pytest.raises(ValueError, match="pure-intra IRAP"):
        decode_gops(plans[1:], plans[0].sps, ["cpu"])
    with pytest.raises(ValueError, match="outside the GOP"):
        decode_gops(plans[:3] + plans[4:], plans[0].sps, ["cpu"])
    with pytest.raises(ValueError, match="empty device list"):
        decode_gops(plans, plans[0].sps, [])
    data = open(os.path.join(DATA, "adv_rot_tsctx_wpp.bin"), "rb").read()
    with pytest.raises(ValueError, match="not one the frame program takes"):
        decode_stream_native(data, gop_devices=["cpu"])
    with pytest.raises(ValueError, match="not both"):
        decode_stream_native(stream8, tile_devices=["cpu"],
                             gop_devices=["cpu"])
