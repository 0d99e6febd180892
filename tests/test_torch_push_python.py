"""The port's per-picture push decoder (libde265_tpu_torch.api.new_decoder(
parse="python"), on CPU tensors: the kernels' plain versions) against the
JAX package's push decoder (libde265_tpu.api.new_decoder) under the same
pushes, each push followed by decode() until it asks for input
(tools/gen_torch_recovery_goldens.trace): the pictures in output order
with their per-plane MD5s and pts, the warning codes in order, the status
and the pictures returned after every decode(), the passed SEI hash
checks, all exact. Also the recipes of tests/test_robustness.py, the
recovery goldens the card is held to, the default segment path's hand-off
to this path, and errors of the device program propagating out of
decode()."""
import json
import os
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(__file__)
DATA = os.path.join(TESTS, "data")
sys.path.insert(0, os.path.join(TESTS, "..", "tools"))

from gen_torch_recovery_goldens import (OUT, build_stream, goldens,  # noqa
                                        trace)

# (vector, push size: 997 or the whole stream at once)
VECTORS = [
    ("intra_64x64_q27", 997), ("intra_104x72_q26", 0), ("i_deblk_sao", 997),
    ("i_strong32", 0), ("i_tskip_nxn", 997), ("b_cabacinit", 0),
    ("b_mixed", 997), ("b_mv", 0), ("b_reflist_mod", 997), ("p_10bit", 0),
    ("p_2pu_amp", 997), ("p_2ref", 0), ("p_cip", 997), ("p_cra", 997),
    ("p_hash_sei", 997), ("p_ltr", 0), ("p_mixed", 997), ("p_pcm", 0),
    ("p_qpdelta", 997), ("p_scaling", 0), ("p_sdh", 997),
    ("p_slices2", 997), ("p_depslices", 0), ("p_temporal", 997),
    ("p_tmvp", 0), ("p_tqbypass", 997), ("p_tskip", 0), ("p_wp", 997),
    ("p_wppx", 0), ("rext_422_104x72", 997), ("rext_444_104x72", 0),
    ("rext_mono_104x72", 997), ("rxt_ccp_444", 0), ("rxt_cqo", 997),
    ("rxt_erdpcm", 0), ("rxt_smooth_off", 997), ("adv_b_wp_2ref", 0),
    ("adv_cqo_tiles", 997), ("rxt_cqo_scaling", 997)]
ROBUST = ["p_slices2", "p_mixed", "b_mixed", "p_cra"]


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _json(x):
    return json.loads(json.dumps(x))


def _both(data, chunk=997, **kw):
    """(port record, JAX record, port decoder)."""
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    got, dec = trace(P, data, chunk or max(1, len(data)), device="cpu",
                     parse="python", **kw)
    want, _ = trace(J, data, chunk or max(1, len(data)), **kw)
    return _json(got), _json(want), dec


def _units(name):
    from libde265_tpu_torch.bitstream.nal import split_annexb
    return list(split_annexb(_load(name)))


def _annexb(units, relabel=None):
    from libde265_tpu_torch.encoder.cabac_enc import \
        add_emulation_prevention as ep
    out = b""
    for i, u in enumerate(units):
        d = u.data
        if relabel and i in relabel:
            b = bytearray(d)
            b[0] = (b[0] & 0x81) | (relabel[i] << 1)
            d = bytes(b)
        out += b"\x00\x00\x00\x01" + ep(d)
    return out


@pytest.mark.parametrize("name,chunk", VECTORS)
def test_push_python_matches_jax(name, chunk):
    got, want, dec = _both(_load(name), chunk)
    assert got == want
    assert got["pictures"], "no pictures"
    assert not dec.stats["n_concealed_frames"]


def test_pictures_come_out_during_the_pushes():
    """One picture per decode() once the DPB bumps it: p_mixed in 997-byte
    pushes gives pictures before the flush."""
    from libde265_tpu_torch import api
    data = _load("p_mixed")
    dec = api.new_decoder(device="cpu", parse="python")
    n = 0
    for i in range(0, len(data), 997):
        api.push_data(dec, data[i:i + 997])
        while api.decode(dec):
            while api.get_next_picture(dec) is not None:
                n += 1
    assert n > 0
    assert dec.stats["n_frames"] >= n


@pytest.mark.parametrize("name", ROBUST)
def test_truncated_and_flipped_match_jax(name):
    """tests/test_robustness.py's recipes: cuts at 0.25/0.5/0.75/0.9 and
    three trials of four bit flips from RandomState(7)."""
    data = _load(name)
    streams = [data[:int(len(data) * f)] for f in (0.25, 0.5, 0.75, 0.9)]
    rng = np.random.RandomState(7)
    for _ in range(3):
        b = bytearray(data)
        for _ in range(4):
            pos = rng.randint(8, len(b))
            b[pos] ^= 1 << rng.randint(8)
        streams.append(bytes(b))
    for s in streams:
        got, want, _ = _both(s)
        assert got == want


def test_garbage_and_empty_match_jax():
    rng = np.random.RandomState(512)
    for data in (b"", b"\x00\x00\x01\xff\xffgarbage", rng.bytes(512),
                 b"\x00\x00\x00\x01" + rng.bytes(64)):
        got, want, _ = _both(data)
        assert got == want


def test_dependent_slice_first_matches_jax():
    units = _units("p_depslices")
    ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
    dep = [u for u in units if u.header.nal_unit_type < 32][2]
    got, want, _ = _both(_annexb(ps + [dep]))
    assert got == want and got["warnings"]


def test_rasl_after_seek_matches_jax():
    """From p_cra's CRA on, the picture after it relabelled RASL_R: skipped
    with RASL_PICTURE_SKIPPED, in both decoders."""
    from libde265_tpu_torch.errors import Warning as W
    units = _units("p_cra")
    ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
    vcl = [u for u in units if u.header.nal_unit_type < 32]
    cra = next(i for i, u in enumerate(vcl) if u.header.nal_unit_type == 21)
    got, want, _ = _both(_annexb(ps + vcl[cra:], relabel={len(ps) + 1: 9}))
    assert got == want
    assert int(W.RASL_PICTURE_SKIPPED) in got["warnings"]


def test_reset_then_seek_matches_jax():
    """Decode half of p_cra, reset, push the parameter sets and the stream
    from its CRA: the same pictures and warnings as the JAX decoder, and
    the manifest's tail."""
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    data = _load("p_cra")
    units = _units("p_cra")
    ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
    vcl = [u for u in units if u.header.nal_unit_type < 32]
    cra = next(i for i, u in enumerate(vcl) if u.header.nal_unit_type == 21)
    seek = _annexb(ps + vcl[cra:])

    def run(mod, **kw):
        dec = mod.new_decoder(**kw)
        mod.push_data(dec, data[:len(data) // 2])
        while mod.decode(dec):
            pass
        mod.reset(dec)
        mod.push_data(dec, seek)
        mod.flush_data(dec)
        out = []
        while True:
            more = mod.decode(dec)
            while True:
                p = mod.get_next_picture(dec)
                if p is None:
                    break
                out.append((p.poc, [p.plane_md5(c) for c in range(3)]))
            if not more:
                break
        codes = []
        while (w := mod.get_warning(dec)) is not None:
            codes.append(int(w))
        return out, codes
    got = run(P, device="cpu", parse="python")
    assert got == run(J)
    m = json.load(open(os.path.join(DATA, "manifest_inter.json")))["p_cra"]
    assert [md5 for _, md5 in got[0]] == \
        [[f[c] for c in "yuv"] for f in m["md5"][cra:]]


def test_temporal_layer_matches_jax():
    """p_temporal at half the frame rate: the operating temporal layer
    gates the NALs and indexes max_num_reorder_pics."""
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    data = _load("p_temporal")

    def run(mod, **kw):
        dec = mod.new_decoder(**kw)
        mod.push_data(dec, data)
        mod.flush_data(dec)
        out = []
        first = True
        while True:
            more = mod.decode(dec)
            if first and dec.sps:
                dec.set_framerate_ratio(50)
                first = False
            while (p := mod.get_next_picture(dec)) is not None:
                out.append((p.poc, p.plane_md5(0)))
            if not more:
                return out
    got = run(P, device="cpu", parse="python")
    assert got == run(J) and got


def test_recovery_goldens_are_current():
    """tools/gen_torch_recovery_goldens.py rebuilds the committed file."""
    with open(OUT) as f:
        assert _json(goldens()) == json.load(f)


def test_recovery_goldens_met_on_cpu():
    """Every recovery case through parse="python" equals the goldens (the
    JAX decoder's): the slice kept in part, grey concealment,
    IMAGE_BUFFER_FULL and DPB_FULL_PICTURE_DROPPED among them; the cases
    marked native also through the default segment path (its hand-off),
    pictures and warnings."""
    from libde265_tpu_torch import api as P
    from libde265_tpu_torch.errors import DecodeError, Warning as W
    with open(OUT) as f:
        gold = json.load(f)
    seen_codes, seen_status = set(), set()
    for name, e in gold.items():
        r = e["recipe"]
        data = build_stream(r)
        got, dec = trace(P, data, r["chunk"], r.get("dpb_size"),
                         device="cpu", parse="python")
        assert _json(got) == e["jax"], name
        seen_codes |= set(got["warnings"])
        seen_status |= {s for s, _ in got["steps"]}
        if r["native"]:
            nat, ndec = trace(P, data, r["chunk"], device="cpu")
            for k in ("pictures", "warnings", "hash_checks"):
                assert _json(nat[k]) == e["jax"][k], (name, k)
            assert ndec.stats["n_python_segments"] == 1
    assert {int(W.SLICE_DATA_CORRUPTED), int(W.DPB_FULL_PICTURE_DROPPED),
            int(W.CHECKSUM_MISMATCH)} <= seen_codes
    assert int(DecodeError.IMAGE_BUFFER_FULL) in seen_status


def test_handoff_on_a_refused_segment(monkeypatch):
    """A segment the native front end refuses (ValueError) is decoded
    again through the per-picture path: the JAX decoder's pictures,
    pts, warnings and hash checks; n_python_segments counts it."""
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    from libde265_tpu_torch.native_frontend import NativeFrontend

    def refuse(self, data, spss, ppss):
        raise ValueError("native front-end error: refused")
    monkeypatch.setattr(NativeFrontend, "parse", refuse)
    for name in ("p_cra", "p_hash_sei", "rxt_cqo"):
        data = _load(name)
        got, dec = trace(P, data, 997, device="cpu")
        want, _ = trace(J, data, 997)
        for k in ("pictures", "warnings", "hash_checks"):
            assert _json(got[k]) == _json(want[k]), (name, k)
        assert dec.stats["n_python_segments"] == dec.stats["n_segments"] \
            >= 1


@pytest.mark.parametrize("name", ["p_cra", "p_hash_sei", "rxt_cqo",
                                  "b_mixed"])
def test_no_handoff_on_clean_streams(name):
    from libde265_tpu_torch import api as P
    _, dec = trace(P, _load(name), 997, device="cpu")
    assert dec.stats["n_python_segments"] == 0
    assert dec.stats["n_segments"] >= 1


@pytest.mark.parametrize("name,target", [
    ("p_mixed", "decode_frame_device"),
    ("rxt_cqo", "reconstruct_frame_device")])
def test_device_errors_propagate(name, target, monkeypatch):
    """An error raised inside the device program (the frame program, the
    hybrid path) leaves decode(): no numpy route, no concealment."""
    from libde265_tpu_torch import api as P
    from libde265_tpu_torch import device_stream

    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(device_stream, target, fail)
    dec = P.new_decoder(device="cpu", parse="python")
    P.push_data(dec, _load(name))
    P.flush_data(dec)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        while P.decode(dec):
            pass
    assert dec.stats["n_host_frames"] == 0
    assert dec.stats["n_concealed_frames"] == 0
    assert P.get_warning(dec) is None


@pytest.mark.parametrize("parse", ["python", "native"])
@pytest.mark.parametrize("exc", [ValueError, AssertionError])
@pytest.mark.parametrize("name,target", [
    ("p_mixed", "decode_frame_device"),
    ("rxt_cqo", "reconstruct_frame_device"),
    ("p_mixed", "update_tables")])
def test_device_refusals_propagate(name, target, exc, parse, monkeypatch):
    """A data error raised by a launch (a kernel's wrapper refusing its
    inputs, an assert inside the frame program, the hybrid path or a K1
    insert) is not a host refusal: it leaves decode() on both paths, with
    no numpy frame, no concealment and no hand-off."""
    from libde265_tpu_torch import api as P
    from libde265_tpu_torch import decoder, device_stream, frame_program

    def fail(*a, **k):
        raise exc("kernel refused its inputs")

    def handoff(*a, **k):
        raise RuntimeError("segment handed to the per-picture path")
    monkeypatch.setattr(device_stream, target, fail)
    if target == "update_tables":
        monkeypatch.setattr(frame_program, target, fail)
    monkeypatch.setattr(decoder.Decoder, "_decode_python", handoff)
    dec = P.new_decoder(device="cpu", parse=parse)
    P.push_data(dec, _load(name))
    P.flush_data(dec)
    with pytest.raises(exc, match="kernel refused"):
        while P.decode(dec):
            pass
    assert dec.stats["n_host_frames"] == 0
    assert dec.stats.get("n_concealed_frames", 0) == 0
    assert dec.stats.get("n_python_segments", 0) == 0


@pytest.mark.parametrize("parse", ["python", "native"])
def test_sps_bit_depth_above_16_refused(parse):
    """The fuzz file id_009 codes a 25-bit luma SPS. Both push decoders
    refuse it with SPS_HEADER_INVALID and then decode as the JAX decoder
    does the stream without that SPS (the JAX decoder takes the SPS: a
    deliberate difference)."""
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    from libde265_tpu_torch.bitstream.paramsets import read_sps
    from libde265_tpu_torch.errors import Warning as W
    name = "id_009_intra_104x72_q26_flip2"
    units = _units(name)
    deep = [i for i, u in enumerate(units) if u.header.nal_unit_type == 33
            and read_sps(u.data).bit_depth_luma > 16]
    assert deep
    data = _load(name)
    got, _ = trace(P, data, len(data), device="cpu", parse=parse)
    want, _ = trace(J, _annexb([u for i, u in enumerate(units)
                                if i not in deep]), len(data))
    got, want = _json(got), _json(want)
    assert got["pictures"] == want["pictures"]
    assert got["hash_checks"] == want["hash_checks"]
    assert got["warnings"] == [int(W.SPS_HEADER_INVALID)] * len(deep) \
        + want["warnings"]
