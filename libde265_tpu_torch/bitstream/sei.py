"""Copy of the decoded-picture-hash part of libde265_tpu/bitstream/sei.py
(the port keeps its own copies of the host modules and imports nothing
of the JAX package): parse_sei, the hash check and the encoder's SEI
writer.

SEI message parsing + decoded-picture-hash verification (spec Annex D).

Capability counterpart of libde265/sei.{h,cc}: parses SEI payloads,
implements decoded_picture_hash (MD5 / CRC / checksum) computation over
reconstructed planes and comparison (sei.cc:251-360). Also provides the
writer used by the encoder (encoder/), so its streams are self-checking.
"""
import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

SEI_DECODED_PICTURE_HASH = 132

HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2


@dataclass
class DecodedPictureHash:
    hash_type: int = HASH_MD5
    digests: List[bytes] = field(default_factory=list)  # per plane


@dataclass
class SEIMessage:
    payload_type: int = 0
    payload: bytes = b""
    picture_hash: Optional[DecodedPictureHash] = None


def parse_sei(nal_data: bytes) -> List[SEIMessage]:
    """nal_data: stripped NAL incl. 2-byte header."""
    out = []
    data = nal_data[2:]
    pos = 0
    while pos < len(data) - 1:  # last byte is rbsp trailing
        t = 0
        while pos < len(data) and data[pos] == 0xFF:
            t += 255
            pos += 1
        if pos >= len(data):
            break
        t += data[pos]; pos += 1
        size = 0
        while pos < len(data) and data[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= len(data):
            break
        size += data[pos]; pos += 1
        payload = data[pos:pos + size]
        pos += size
        msg = SEIMessage(payload_type=t, payload=payload)
        if t == SEI_DECODED_PICTURE_HASH:
            msg.picture_hash = _parse_picture_hash(payload)
        out.append(msg)
        if pos < len(data) and data[pos] == 0x80:
            break
    return out


def _parse_picture_hash(payload: bytes) -> DecodedPictureHash:
    h = DecodedPictureHash(hash_type=payload[0])
    pos = 1
    per = {HASH_MD5: 16, HASH_CRC: 2, HASH_CHECKSUM: 4}[h.hash_type]
    while pos + per <= len(payload):
        h.digests.append(payload[pos:pos + per])
        pos += per
    return h


def compute_plane_hash(plane: np.ndarray, hash_type: int, bitdepth: int = 8) -> bytes:
    """spec D.3.19 per-plane hash (8-bit path; 16-bit planes hashed LE)."""
    data = np.ascontiguousarray(plane)
    if bitdepth <= 8:
        raw = data.astype(np.uint8).tobytes()
    else:
        raw = data.astype("<u2").tobytes()
    if hash_type == HASH_MD5:
        return hashlib.md5(raw).digest()
    if hash_type == HASH_CRC:
        crc = 0xFFFF
        for b in raw:
            for bit in range(7, -1, -1):
                crc_msb = (crc >> 15) & 1
                crc = ((crc << 1) | ((b >> bit) & 1)) & 0xFFFF
                if crc_msb:
                    crc ^= 0x1021
        for _ in range(16):
            crc_msb = (crc >> 15) & 1
            crc = (crc << 1) & 0xFFFF
            if crc_msb:
                crc ^= 0x1021
        return bytes([(crc >> 8) & 0xFF, crc & 0xFF])
    # checksum
    h, w = plane.shape
    yy, xx = np.mgrid[0:h, 0:w]
    xor_mask = ((xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8)).astype(np.uint32)
    vals = (data.astype(np.uint32) ^ xor_mask) & 0xFF
    s = int(vals.sum() & 0xFFFFFFFF)
    if bitdepth > 8:
        vals_hi = ((data.astype(np.uint32) >> 8) ^ xor_mask) & 0xFF
        s = (s + int(vals_hi.sum())) & 0xFFFFFFFF
    return s.to_bytes(4, "big")


def verify_picture_hash(planes, ph: DecodedPictureHash, bitdepth=8) -> bool:
    for i, plane in enumerate(planes):
        if i >= len(ph.digests):
            break
        if compute_plane_hash(plane, ph.hash_type, bitdepth) != ph.digests[i]:
            return False
    return True


def write_picture_hash_sei(planes, hash_type=HASH_MD5, bitdepth=8) -> bytes:
    """Build a suffix-SEI NAL (type 40) carrying decoded_picture_hash."""
    from ..encoder.cabac_enc import BitWriter, add_emulation_prevention
    from ..encoder.headers import nal_header
    digests = b"".join(compute_plane_hash(p, hash_type, bitdepth) for p in planes)
    payload = bytes([hash_type]) + digests
    w = BitWriter()
    nal_header(w, 40)  # SUFFIX_SEI
    t = SEI_DECODED_PICTURE_HASH
    while t >= 255:
        w.put_bits(0xFF, 8)
        t -= 255
    w.put_bits(t, 8)
    size = len(payload)
    while size >= 255:
        w.put_bits(0xFF, 8)
        size -= 255
    w.put_bits(size, 8)
    for b in payload:
        w.put_bits(b, 8)
    w.rbsp_trailing()
    return add_emulation_prevention(w.data())
