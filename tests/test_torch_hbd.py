"""10- and 12-bit 4:2:0 through the port (CPU tensors: the kernels' plain
versions) against the JAX package on the same inputs, exact (the decode
is integer): the bit-depth gate, the final device state of whole streams,
K1 writing int16 tile tables (against the Pallas kernel in interpret
mode), the pipelined decoder and the C++ packer at high bit depth, and
the tile-column decoder on a 10-bit tile stream encoded here."""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
# the committed 4:2:0 vectors above 8 bits (MD5s in test_torch_decode.py)
HBD = ["p_10bit", "rext_420_inter_12b", "rxt_cqo_10b",
       "rxt_rice_scaling_10b", "adv_cra_scaling_10b_amp",
       "adv_wpp_dep10_scaling"]


def _data(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _plans(name):
    from libde265_tpu_torch.api import _parse
    return _parse(_data(name))


def _manifest(name):
    mf = {"adv": "manifest_adv.json", "rext": "manifest_rext.json",
          "rxt": "manifest_rext_tools.json"}.get(name.split("_")[0],
                                                  "manifest_inter.json")
    with open(os.path.join(DATA, mf)) as f:
        return json.load(f)[name]


def _md5s(planes):
    return [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
            for p in planes]


@pytest.mark.parametrize("name", HBD)
def test_check_slice_accepts_420_up_to_12_bits(name):
    """Every high-bit-depth 4:2:0 vector passes the gate; 13 bits and the
    other chroma formats are still refused."""
    from libde265_tpu_torch.frame_program import check_slice
    from libde265_tpu_torch.packing import stream_cfg
    plans = _plans(name)
    cfg = stream_cfg(plans, plans[0].sps)
    assert cfg.bitdepth in (10, 12) and cfg.chroma_fmt == 1
    check_slice(cfg)
    for bad, what in (({"bitdepth": 13}, "bit depth 13"),
                      ({"chroma_fmt": 2}, "chroma format 2")):
        with pytest.raises(NotImplementedError, match=what):
            check_slice(dataclasses.replace(cfg, **bad))


@pytest.mark.parametrize("name", ["p_10bit", "rext_420_inter_12b",
                                  "rxt_rice_scaling_10b"])
def test_final_state_matches_jax(name, monkeypatch):
    """Same plans through both decoders: identical int16 DPB stacks,
    int16 tile tables (pad rows included) and slot assignment; output
    pictures are uint16, as the JAX decoder's. A 10-bit scaling-list
    vector is where the JAX dequant's int32 arithmetic (the port's is
    int64) would wrap first; it does not on this one. (The two adv_*
    10-bit scaling-list vectors: tests/test_adversarial.py holds the
    JAX DeviceStreamDecoder to their MD5s, test_torch_decode.py the
    port.)"""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    from libde265_tpu.device_stream import DeviceStreamDecoder as JaxDec
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    plans = _plans(name)
    jd = JaxDec(plans, plans[0].sps)
    jd.decode_all()
    pd = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    pd.decode_all()
    assert pd.slot_of == jd.slot_of
    assert pd.ty.dtype == pd.tc.dtype == torch.int16
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), pd.state(),
                          (jd.dy, jd.dcb, jd.dcr, jd.ty, jd.tc)):
        b = np.asarray(b)
        assert a.dtype == getattr(torch, b.dtype.name), what
        assert np.array_equal(a.numpy(), b), what
    assert pd.dtype == jd.dtype == np.uint16
    for p in plans:
        got = pd.planes_of(p.frame_id)
        want = jd.planes_of(p.frame_id)
        assert [g.dtype for g in got] == [np.dtype(np.uint16)] * 3
        assert _md5s(got) == _md5s(want), p.frame_id


@pytest.mark.parametrize("H,W,NS,slot", [(64, 304, 4, 3), (72, 136, 4, 2)])
def test_k1_int16_table_matches_pallas(H, W, NS, slot):
    """K1 into an int16 table (its plain version on the CPU) against
    update_tile_table_pallas in interpret mode, 10-bit samples: equal on
    every valid row of the written slot, its layout rows zeroed, the
    other slots untouched."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import PAD_C, PAD_Y, n_tiles_c, \
        n_tiles_y
    from libde265_tpu.ops.pallas.mc_tables import update_tile_table_pallas
    from libde265_tpu_torch.ops.kernels.mc_tables import update_tile_table
    rng = np.random.RandomState(H + W)
    Y, Cb, Cr = (rng.randint(0, 1024, s).astype(np.int16)
                 for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    for T, planes, pad, (ntyp, ntx), nty in (
            (16, [Y], PAD_Y, n_tiles_y(H, W), (H + 20) // 4),
            (8, [Cb, Cr], PAD_C, n_tiles_c(H // 2, W // 2),
             (H // 2 + 12) // 4)):
        P = len(planes)
        init = rng.randint(-2048, 2048, (NS * ntyp * ntx, P * T * T)) \
            .astype(np.int16)
        padded = np.stack([np.pad(p, pad, mode="edge") for p in planes])
        want = np.asarray(update_tile_table_pallas(
            jnp.asarray(init), jnp.asarray(padded), np.int32(slot), T,
            interpret=True)).reshape(NS, ntyp, ntx, -1)
        n = update_tile_table.launches
        got = update_tile_table(torch.as_tensor(init),
                                torch.as_tensor(padded), slot, T)
        assert update_tile_table.launches == n and got.dtype == torch.int16
        got = got.numpy().reshape(NS, ntyp, ntx, -1)
        assert np.array_equal(got[slot, :nty], want[slot, :nty]), T
        assert not got[slot, nty:].any(), "layout rows are zeroed"
        others = [s for s in range(NS) if s != slot]
        assert np.array_equal(got[others],
                              init.reshape(NS, ntyp, ntx, -1)[others]), T


@pytest.mark.parametrize("name", ["p_10bit", "rext_420_inter_12b",
                                  "adv_cra_scaling_10b_amp"])
def test_pipelined_matches_decode_all(name):
    """decode_all_pipelined (batch=2, two pack workers) at 10 and 12 bits:
    every frame dispatched by the pipeline, MD5-equal to the manifest,
    and the final state equal to decode_all's."""
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    plans = _plans(name)
    man = _manifest(name)
    dec = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    dec.decode_all_pipelined(batch=2, pack_workers=2)
    assert dec.n_pipelined_frames == len(plans)
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    for i, p in enumerate(outs):
        assert _md5s(dec.planes_of(p.frame_id)) == \
            [man["md5"][i][k] for k in ("y", "u", "v")], i
    ref = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    ref.decode_all()
    assert dec.slot_of == ref.slot_of
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), dec.state(),
                          ref.state()):
        assert torch.equal(a, b), what


def test_native_pack_at_high_bit_depth():
    """The C++ packer on rext_420_inter_12b's P frames (int16 tables, no
    intra) fills the same bytes as numpy pack_frame + pack_blob. The
    10-bit scaling-list and intra layouts it refuses (None: the numpy
    packer runs), before it reads the layout."""
    from libde265_tpu_torch import packing as P
    plans = _plans("rext_420_inter_12b")
    cfg = dataclasses.replace(P.stream_cfg(plans, plans[0].sps), intra=(),
                              intra_C=0)
    fid_slot = {p.frame_id: i % P.REF_SLOTS for i, p in enumerate(plans)}
    pf = [p for p in plans if not P.frame_has_intra(p)]
    assert len(pf) == 2 and cfg.bitdepth == 12
    packed = [P.pack_frame(p, cfg, fid_slot) for p in pf]
    stacked = {k: np.stack([t[k] for t in packed]) for k in packed[0]}
    meta, totals = P.blob_meta(stacked)
    nat = P.pack_blob_native(pf, cfg, fid_slot, meta, totals)
    bufs = P.pack_blob(stacked, meta, totals)
    assert nat is not None and sorted(nat) == sorted(bufs)
    for k in bufs:
        assert nat[k].tobytes() == bufs[k].tobytes(), k
    for name in ("rxt_rice_scaling_10b", "p_10bit"):
        plans = _plans(name)
        cfg = P.stream_cfg(plans, plans[0].sps)
        assert cfg.scaling or cfg.intra, name
        assert P.pack_blob_native(plans, cfg, {}, None, None) is None, name


def test_tile_decoder_on_a_10_bit_tile_stream():
    """A 256x64 10-bit stream with two tile columns (IDR + 2 P frames),
    encoded here by the JAX package's encoder: the port's tile-column
    decoder (K5 writing int16 tables, K2 in strip form) decodes every P
    frame as strips, MD5-equal to the JAX package's single-device
    DeviceStreamDecoder on the same stream."""
    sys.path.insert(0, TOOLS)
    from gen_inter_streams import make_frames
    from libde265_tpu.device_stream import DeviceStreamDecoder as JaxDec
    from libde265_tpu.encoder import Encoder, EncoderConfig
    from libde265_tpu_torch.api import _parse, decode_stream_native
    W, H = 256, 64
    frames = [[(p.astype(np.uint16) << 2) | (p & 3) for p in f]
              for f in make_frames(3, W, H)]
    data = Encoder(EncoderConfig(
        width=W, height=H, qp=30, bit_depth=10, inter_mode="mv",
        inter_residual=True, tiles=(2, 1), log2_ctb=6, cu_log2=4,
        num_ref_l0=2, temporal_mvp=True, disable_deblocking=False,
        sao=True)).encode(frames)
    plans = _parse(data)
    jd = JaxDec(plans, plans[0].sps)
    jd.decode_all()
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    want = [_md5s(jd.planes_of(p.frame_id)) for p in outs]
    st = {}
    got = decode_stream_native(data, stats=st, tile_devices=["cpu", "cpu"])
    assert (st["n_strip_frames"], st["n_host_frames"]) == (2, 0)
    assert [_md5s(g.planes) for g in got] == want
    assert got[0].planes[0].dtype == np.uint16
    assert any((g.planes[0] & 3).any() for g in got)   # real 10-bit detail
