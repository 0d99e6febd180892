"""Annex-B bytes as the benchmark's clients push them, and the digests
that judge what comes back. Written for the benchmark alone: nothing of
the program under test is imported here.

An access unit is grouped as H.265 clause 7.4.2.4.4 has it: after the
last VCL NAL of a picture, the first VPS, SPS, PPS, access unit
delimiter, prefix SEI, NAL of types 41-44 or 48-55, or VCL NAL with
first_slice_segment_in_pic_flag set starts the next one. Every byte of
the stream belongs to exactly one NAL unit (the zero bytes before a
start code go with the NAL that follows), so the access units put
together give the stream back.
"""
import hashlib
from dataclasses import dataclass

import numpy as np

IRAP_TYPES = range(16, 24)
PARAM_SET_TYPES = (32, 33, 34)
_AU_STARTERS = {32, 33, 34, 35, 39} | set(range(41, 45)) \
    | set(range(48, 56))


@dataclass(frozen=True)
class Nal:
    begin: int          # first byte: leading zeros and start code included
    end: int            # one past the last byte
    type: int
    first_slice: bool   # a VCL NAL that starts a picture


@dataclass(frozen=True)
class AccessUnit:
    begin: int
    end: int
    nals: tuple
    picture: object     # decode-order index of its picture; None: no VCL
    irap: bool          # its picture is an IRAP picture


def nal_units(data):
    """The NAL units of an Annex-B byte string, in order."""
    codes = []
    i = 0
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        codes.append(j)
        i = j + 3
    nals = []
    prev = 0
    for k, c in enumerate(codes):
        begin = c
        while begin > prev and data[begin - 1] == 0:
            begin -= 1
        if k == 0:
            begin = 0
        elif nals:
            nals[-1] = Nal(nals[-1].begin, begin, nals[-1].type,
                           nals[-1].first_slice)
        p = c + 3
        t = (data[p] >> 1) & 63 if p < len(data) else -1
        first = t <= 31 and p + 2 < len(data) and data[p + 2] >> 7 == 1
        nals.append(Nal(begin, len(data), t, bool(first)))
        prev = p
    return nals


def access_units(data):
    """The access units of an Annex-B byte string, in decode order."""
    groups, cur, vcl = [], [], False
    for n in nal_units(data):
        is_vcl = 0 <= n.type <= 31
        if cur and vcl and (n.type in _AU_STARTERS
                            or (is_vcl and n.first_slice)):
            groups.append(cur)
            cur, vcl = [], False
        cur.append(n)
        vcl = vcl or is_vcl
    if cur:
        groups.append(cur)
    out, pic = [], 0
    for g in groups:
        vcls = [n for n in g if 0 <= n.type <= 31]
        out.append(AccessUnit(g[0].begin, g[-1].end, tuple(g),
                              pic if vcls else None,
                              bool(vcls) and vcls[0].type in IRAP_TYPES))
        pic += bool(vcls)
    return out


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def plane_md5(plane):
    """MD5 of one plane's samples as dec265 writes them: one byte a
    sample up to 8 bits, else two, little-endian."""
    a = np.ascontiguousarray(plane)
    if a.dtype.itemsize > 1:
        a = a.astype("<u2")
    return hashlib.md5(a.tobytes()).hexdigest()
