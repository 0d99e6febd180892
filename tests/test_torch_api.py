"""The port's push API (libde265_tpu_torch.api: new_decoder / push_data /
flush_data / decode / get_next_picture / reset / get_warning, over
libde265_tpu_torch.decoder.Decoder on CPU tensors: the kernels' plain
versions) against the JAX package's (libde265_tpu.api over its Python
decoder) under the same pushes: the pictures in output order with their
per-plane MD5s and pts, the SEI picture-hash checks and the typed
warnings, all exact."""
import json
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
CHUNK = 997


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _run(mod, data, chunk=CHUNK, setup=None, **kw):
    """Push `data` in `chunk`-byte pieces, pts 1000 + piece index; decode
    until done, draining pictures as they come. Returns ([(poc, (md5 y,
    u, v), pts)], [warning codes], hash_checks_passed, decoder)."""
    dec = mod.new_decoder(**kw)
    if setup:
        setup(dec)
    for i in range(0, len(data), chunk):
        mod.push_data(dec, data[i:i + chunk], pts=1000 + i // chunk)
    mod.flush_data(dec)
    out = []
    while True:
        more = mod.decode(dec)
        while True:
            p = mod.get_next_picture(dec)
            if p is None:
                break
            out.append((p.poc, tuple(p.plane_md5(c) for c in range(3)),
                        p.pts))
        if not more:
            break
    codes = []
    while True:
        w = mod.get_warning(dec)
        if w is None:
            break
        codes.append(int(w))
    return out, codes, getattr(dec, "hash_checks_passed", 0), dec


def _both(data, setup=None, **kw):
    import libde265_tpu.api as J
    from libde265_tpu_torch import api as P
    return (_run(P, data, setup=setup, device="cpu", **kw)[:3],
            _run(J, data, setup=setup, **kw)[:3])


def _ep(payload):
    from libde265_tpu.encoder.cabac_enc import add_emulation_prevention
    return b"\x00\x00\x00\x01" + add_emulation_prevention(payload)


def _relabel(nal_data, new_type):
    b = bytearray(nal_data)
    b[0] = (b[0] & 0x81) | (new_type << 1)
    return bytes(b)


def _units(name):
    from libde265_tpu.bitstream.nal import split_annexb
    return list(split_annexb(_load(name)))


def _bla_stream():
    """p_cra with its CRA pictures relabelled BLA_W_LP: a segment cut at
    each, and concealed missing references after it."""
    return b"".join(_ep(_relabel(u.data, 16) if u.header.nal_unit_type == 21
                        else u.data) for u in _units("p_cra"))


def _rasl_stream():
    """p_cra from its first CRA on, the picture after it relabelled RASL_R:
    skipped (a stream-initial CRA), with RASL_PICTURE_SKIPPED."""
    units = _units("p_cra")
    ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
    vcl = [u for u in units if u.header.nal_unit_type < 32]
    cra = next(i for i, u in enumerate(vcl) if u.header.nal_unit_type == 21)
    return b"".join(_ep(u.data) for u in ps) + b"".join(
        _ep(_relabel(u.data, 9) if i == 1 else u.data)
        for i, u in enumerate(vcl[cra:]))


@pytest.mark.parametrize("name", ["intra_64x64_q27", "p_hash_sei", "p_cra",
                                  "rxt_cqo", "bla", "rasl"])
def test_push_matches_jax(name):
    """997-byte pushes, each with its own pts: the same (poc, MD5s, pts)
    list, hash checks and warnings as the JAX decoder. rxt_cqo's frames
    take the hybrid device path; "bla" cuts segments at BLA pictures,
    "rasl" skips a RASL picture after a stream-initial CRA."""
    data = {"bla": _bla_stream, "rasl": _rasl_stream}.get(
        name, lambda: _load(name))()
    got, want = _both(data)
    assert got == want
    assert got[0], "no pictures"
    if name == "rasl":
        from libde265_tpu_torch.errors import Warning as W
        assert W.RASL_PICTURE_SKIPPED in got[1]


def _flip_sei_md5(data, which):
    """`data` with one byte of the MD5 of the `which`-th decoded-picture-
    hash SEI flipped."""
    from libde265_tpu.bitstream.nal import split_annexb
    out, k = [], 0
    for u in split_annexb(data):
        d = u.data
        if u.header.nal_unit_type in (39, 40) and d[2] == 132:
            if k == which:
                b = bytearray(d)
                b[2 + 2 + 1 + 5] ^= 0x5A      # type, size, hash type
                d = bytes(b)
            k += 1
        out.append(_ep(d))
    assert k, "no picture-hash SEI"
    return b"".join(out)


@pytest.mark.parametrize("flip", [None, 0, 2])
def test_hash_checks_match_jax(flip):
    """p_hash_sei's SEI picture hashes: every one passes, and with one MD5
    byte flipped, that picture gives CHECKSUM_MISMATCH, in both
    decoders, the same count of passed checks."""
    from libde265_tpu_torch.errors import Warning as W
    data = _load("p_hash_sei")
    if flip is not None:
        data = _flip_sei_md5(data, flip)
    got, want = _both(data)
    assert got == want
    n_hash = 3
    assert got[2] == n_hash - (flip is not None)
    assert got[1].count(W.CHECKSUM_MISMATCH) == (flip is not None)


def test_peek_release_pts_chroma():
    """de265 API surface as tests/test_tools.py holds it: peek does not
    consume, release does, pts and chroma format of the pictures."""
    from libde265_tpu_torch.api import (decode_stream, new_decoder,
                                        peek_next_picture,
                                        release_next_picture)
    dec = new_decoder(device="cpu")
    dec.push_data(_load("intra_64x64_q27"), pts=77000)
    dec.flush()
    while dec.decode():
        pass
    p = peek_next_picture(dec)
    assert p is not None and p.pts == 77000 and p.chroma_format == 1
    assert peek_next_picture(dec).poc == p.poc    # peek does not consume
    n = 0
    while peek_next_picture(dec) is not None:     # release consumes
        release_next_picture(dec)
        n += 1
    assert n == 2 and peek_next_picture(dec) is None
    assert decode_stream(_load("rext_mono_104x72"),
                         device="cpu")[0].chroma_format == 0
    assert decode_stream(_load("rext_422_104x72"),
                         device="cpu")[0].chroma_format == 2


def test_reset_then_seek():
    """Decode a prefix, reset, then decode from a CRA (the parameter sets
    pushed again): the pictures from the CRA on equal the manifest's
    tail, as tests/test_robustness.py holds the JAX decoder to it."""
    from libde265_tpu_torch.api import get_next_picture, new_decoder
    m = json.load(open(os.path.join(DATA, "manifest_inter.json")))["p_cra"]
    data = _load("p_cra")
    dec = new_decoder(device="cpu")
    dec.push_data(data[:len(data) // 2])
    while dec.decode():
        pass
    dec.reset()
    units = _units("p_cra")
    ps = [u for u in units if u.header.nal_unit_type in (32, 33, 34)]
    vcl = [u for u in units if u.header.nal_unit_type < 32]
    cra_i = next(i for i, u in enumerate(vcl) if u.header.nal_unit_type == 21)
    dec.push_data(b"".join(_ep(u.data) for u in ps + vcl[cra_i:]))
    dec.flush()
    got = []
    while dec.decode():
        p = get_next_picture(dec)
        if p:
            got.append(p)
    while True:
        p = get_next_picture(dec)
        if p is None:
            break
        got.append(p)
    assert len(got) == m["frames"] - cra_i
    for i, pic in enumerate(got):
        assert [pic.plane_md5(c) for c in range(3)] == \
            [m["md5"][cra_i + i][k] for k in "yuv"]


@pytest.mark.parametrize("how,n", [("limit_tid", 3), (100, 6), (50, 3),
                                   (30, 3)])
def test_temporal_layers_match_jax(how, n):
    """p_temporal (two temporal layers) with limit_tid 0 or a framerate
    ratio: the sub-layer NALs are dropped before the native parse, and
    the pictures equal the JAX decoder's (the reference's -T counts)."""
    def setup(dec):
        if how == "limit_tid":
            dec.limit_tid = 0
        else:
            dec.set_framerate_ratio(how)
    got, want = _both(_load("p_temporal"), setup=setup)
    assert got == want and len(got[0]) == n


def test_change_framerate():
    from libde265_tpu_torch.api import new_decoder
    dec = new_decoder(device="cpu")
    dec.push_data(_load("p_temporal"))
    dec.flush()
    while dec.decode():
        pass
    assert dec.get_highest_tid() == 1
    assert dec.change_framerate(-1) == 50
    assert dec.change_framerate(+1) == 100


def test_invalid_sps_warns_as_jax():
    """A truncated SPS: SPS_HEADER_INVALID, then the warnings of what
    follows, the same codes as the JAX decoder, and no picture."""
    from libde265_tpu_torch.errors import Warning as W
    data = b"".join(_ep(u.data[:6] if u.header.nal_unit_type == 33
                        else u.data) for u in _units("intra_64x64_q27"))
    got, want = _both(data)
    assert got == want
    assert got[1][:1] == [W.SPS_HEADER_INVALID] and not got[0]


def test_status_and_return_value():
    """decode() returns True while NALs remain; with the input used up
    and no flush, False with WAITING_FOR_INPUT; after flush, the last
    segment decodes and it returns False with OK."""
    from libde265_tpu_torch.api import new_decoder
    from libde265_tpu_torch.errors import DecodeError
    dec = new_decoder(device="cpu")
    dec.push_data(_load("intra_64x64_q27"))
    n = 0
    while dec.decode():
        n += 1
    assert n > 0 and dec.status == DecodeError.WAITING_FOR_INPUT
    assert dec.get_next_picture() is None
    dec.flush()
    while dec.decode():
        pass
    assert dec.status == DecodeError.OK
    assert dec.get_next_picture() is not None


@pytest.mark.parametrize("name", ["p_hash_sei", "rxt_cqo", "ld4k_light"])
def test_escape_restores_stream_bytes(name):
    """decoder.escape puts the emulation-prevention bytes back: each NAL
    it rebuilds stands in the stream as it is, and unescapes to the
    parser's payload and skip list."""
    from libde265_tpu_torch.bitstream.nal import split_annexb, unescape_rbsp
    from libde265_tpu_torch.decoder import escape
    data = _load(name)
    units = split_annexb(data)
    assert any(u.skipped for u in units)
    pos = 0
    for u in units:
        raw = escape(u)
        pos = data.index(b"\x00\x00\x01" + raw, pos) + 3 + len(raw)
        assert unescape_rbsp(raw) == (u.data, u.skipped)


def test_cuda_request_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from libde265_tpu_torch.api import decode_stream, new_decoder
    with pytest.raises(RuntimeError):
        new_decoder()
    with pytest.raises(RuntimeError):
        decode_stream(_load("intra_64x64_q27"))
