"""Access units as the clients split the streams, and the digests."""
import hashlib
import os

import numpy as np
import pytest

from benchmark.stream import access_units, nal_units, plane_md5
from bench_cells import DATA


def _read(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,n,iraps", [
    ("ld4k_light", 33, [0]),
    ("gop1080p", 96, list(range(0, 96, 6))),
    ("p_mv", 4, [0])])
def test_access_units_cover_the_stream(name, n, iraps):
    data = _read(name)
    aus = access_units(data)
    assert b"".join(data[a.begin:a.end] for a in aus) == data
    assert [a.picture for a in aus] == list(range(n))
    assert [a.picture for a in aus if a.irap] == iraps
    assert [n.type for n in aus[0].nals][:3] == [32, 33, 34]


def _nal(t, first=True, body=b"\x55\x66", zeros=2):
    # 2-byte header (layer 0, tid 1); a slice's first payload bit is
    # first_slice_segment_in_pic_flag
    head = bytes([t << 1, 1])
    lead = bytes([0x80 if first else 0x00]) if t <= 31 else b"\x11"
    return b"\x00" * zeros + b"\x01" + head + lead + body


def test_access_unit_rules():
    data = (_nal(35, zeros=3) + _nal(32) + _nal(33) + _nal(34) + _nal(39)
            + _nal(19) + _nal(19, first=False) + _nal(40)
            + b"\x00\x00"                      # trailing zero bytes
            + _nal(1, zeros=3) + _nal(1, first=False) + _nal(1)
            + _nal(35) + _nal(1))
    nals = nal_units(data)
    assert b"".join(data[x.begin:x.end] for x in nals) == data
    assert [x.type for x in nals] == [35, 32, 33, 34, 39, 19, 19, 40, 1,
                                      1, 1, 35, 1]
    aus = access_units(data)
    assert [[x.type for x in a.nals] for a in aus] == [
        [35, 32, 33, 34, 39, 19, 19, 40], [1, 1], [1], [35, 1]]
    assert [a.picture for a in aus] == [0, 1, 2, 3]
    assert [a.irap for a in aus] == [True, False, False, False]
    # the zeros before a start code go with the NAL that follows
    assert data[aus[1].begin:aus[1].begin + 4] == b"\x00\x00\x00\x00"


def test_plane_md5():
    a8 = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert plane_md5(a8) == hashlib.md5(a8.tobytes()).hexdigest()
    # a view is digested as its samples, not as the array it views
    assert plane_md5(a8[:, 1:3]) == hashlib.md5(
        bytes([1, 2, 5, 6, 9, 10])).hexdigest()
    # above 8 bits: two bytes a sample, little-endian
    a16 = np.array([[1, 256]], dtype=">u2")
    assert plane_md5(a16) == hashlib.md5(b"\x01\x00\x00\x01").hexdigest()
