"""Copy of libde265_tpu/encoder/cabac_enc.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

CABAC encoder engine + RBSP bit writer (spec 9.3.4.3.2-9.3.4.3.5).

Capability counterpart of libde265/cabac.{h,cc} encoder half
(CABAC_encoder_bitstream) — written from the standard's arithmetic-encoding
flow (EncodeDecision / EncodeBypass / EncodeTerminate / EncodeFlush with
PutBit + bitsOutstanding carry resolution).
"""
from ..bitstream.cabac import RANGE_TAB_LPS, TRANS_IDX_LPS


class BitWriter:
    """MSB-first bit writer with Exp-Golomb helpers and RBSP finishing."""

    def __init__(self):
        self.bytes = bytearray()
        self.cur = 0
        self.nbits = 0

    def put_bit(self, b):
        self.cur = (self.cur << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.bytes.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def put_bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put_bit((v >> i) & 1)

    def put_uvlc(self, v):
        v += 1
        n = v.bit_length()
        self.put_bits(0, n - 1)
        self.put_bits(v, n)

    def put_svlc(self, v):
        if v <= 0:
            self.put_uvlc(-2 * v)
        else:
            self.put_uvlc(2 * v - 1)

    def byte_align_zero(self):
        while self.nbits:
            self.put_bit(0)

    def rbsp_trailing(self):
        self.put_bit(1)
        self.byte_align_zero()

    def data(self):
        assert self.nbits == 0
        return bytes(self.bytes)


def add_emulation_prevention(payload: bytes) -> bytes:
    """Insert 0x03 after any 00 00 before 00/01/02/03 (spec 7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in payload:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class CabacEncoder:
    """Arithmetic encoder writing into its own byte buffer (unstuffed)."""

    def __init__(self):
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self.writer = BitWriter()
        self.num_bins = 0

    # --- carry-resolved bit output (spec 9.3.4.3.2 PutBit) ---------------
    def _put_bit(self, b):
        if self.first_bit:
            self.first_bit = False
        else:
            self.writer.put_bit(b)
        while self.bits_outstanding > 0:
            self.writer.put_bit(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.bits_outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    # --- bin encoders -----------------------------------------------------
    def encode_bin(self, ctx, b):
        """ctx: [pStateIdx, valMps] (same layout as the decoder's table)."""
        state, mps = ctx[0], ctx[1]
        lps = RANGE_TAB_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        self.num_bins += 1
        if b != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]
        else:
            ctx[0] = state + 1 if state < 62 else state
        self._renorm()

    def encode_bypass(self, b):
        self.num_bins += 1
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((v >> i) & 1)

    def encode_terminate(self, b):
        """spec 9.3.4.3.4 EncodeTerminate (+ 9.3.4.3.5 EncodeFlush on 1).
        The final '1' written by the flush doubles as the RBSP stop bit."""
        self.num_bins += 1
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            v = ((self.low >> 7) & 3) | 1
            self.writer.put_bits(v, 2)
            self.writer.byte_align_zero()
        else:
            self._renorm()

    def reset_engine(self):
        """Restart arithmetic coding after a raw-bits section (PCM)."""
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    # --- binarizations ----------------------------------------------------
    def encode_tu_bypass(self, v, c_max):
        for i in range(v):
            self.encode_bypass(1)
        if v < c_max:
            self.encode_bypass(0)

    def encode_eg_bypass(self, v, k):
        """k-th order Exp-Golomb bypass (inverse of decode_eg_bypass)."""
        nz = 0
        base = 0
        while v >= (base + (1 << (nz + k))):
            base += 1 << (nz + k)
            nz += 1
        for _ in range(nz):
            self.encode_bypass(1)
        self.encode_bypass(0)
        self.encode_bypass_bits(v - base, nz + k)

    def data(self):
        return bytes(self.writer.bytes)
