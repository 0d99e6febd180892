"""Copy of libde265_tpu/bitstream/cabac.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

CABAC binary arithmetic decoder, implemented directly from H.265 spec
clause 9.3.4.3 (ivlCurrRange/ivlOffset formulation).

Capability counterpart of libde265/cabac.{h,cc} — but written
from the standard text: we use the spec's 9-bit offset register + on-demand bit
reads instead of the reference's 16-bit look-ahead register.

Spec Table 9-46 (rangeTabLps) and Table 9-47 (transIdxLps) are normative
constants of the format and appear verbatim in every conforming decoder.
"""

# rangeTabLps[pStateIdx][qRangeIdx]  (spec Table 9-46)
RANGE_TAB_LPS = [
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216), (123, 150, 178, 205),
    (116, 142, 169, 195), (111, 135, 160, 185), (105, 128, 152, 175), (100, 122, 144, 166),
    (95, 116, 137, 158), (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116), (66, 80, 95, 110),
    (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94), (53, 65, 77, 89),
    (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62), (35, 43, 51, 59),
    (33, 41, 48, 56), (32, 39, 46, 53), (30, 37, 43, 50), (29, 35, 41, 48),
    (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33), (19, 23, 27, 31),
    (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27), (15, 19, 22, 25),
    (14, 18, 21, 24), (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18), (10, 12, 15, 17),
    (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14), (8, 10, 12, 14),
    (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2),
]

# transIdxLps[pStateIdx]  (spec Table 9-47); transIdxMps = min(pStateIdx+1, 62)
TRANS_IDX_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
)


TRACE_LABEL = [""]


class CabacDecoder:
    """Context state lives in an external list of [pStateIdx, valMps] pairs
    (see contextmodel.ContextModelTable); the engine only holds range/offset."""

    __slots__ = ("data", "bytepos", "bitcnt", "range", "offset", "n_bins", "trace")

    def __init__(self, data: bytes, start_byte: int = 0):
        self.trace = None  # optional list collecting (kind, bit, range) per bin
        self.data = data
        self.bytepos = start_byte
        self.bitcnt = 0  # bits consumed from current byte
        self.n_bins = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self.read_bit()

    def read_bit(self) -> int:
        bp = self.bytepos
        if bp >= len(self.data):
            # past the end: spec decoders read zeros (corrupted-stream guard)
            self.bitcnt += 1
            if self.bitcnt == 8:
                self.bitcnt = 0
                self.bytepos += 1
            return 0
        b = self.data[bp]
        bit = (b >> (7 - self.bitcnt)) & 1
        self.bitcnt += 1
        if self.bitcnt == 8:
            self.bitcnt = 0
            self.bytepos += 1
        return bit

    # --- bin decoders ----------------------------------------------------

    def decode_bin(self, ctx) -> int:
        """Regular (context-coded) bin. ctx is a 2-list [pStateIdx, valMps]."""
        state, mps = ctx[0], ctx[1]
        state_before = (state, mps)
        lps = RANGE_TAB_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        self.n_bins += 1
        if self.offset >= self.range:
            # LPS path
            bit = 1 - mps
            self.offset -= self.range
            self.range = lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]
        else:
            bit = mps
            ctx[0] = state + 1 if state < 62 else state
        # renormalize (spec 9.3.4.3.3)
        rng, off = self.range, self.offset
        while rng < 256:
            rng <<= 1
            off = (off << 1) | self.read_bit()
        self.range, self.offset = rng, off
        if self.trace is not None:
            self.trace.append(("b", bit, rng, TRACE_LABEL[0], state_before))
        return bit

    def decode_bypass(self) -> int:
        """Bypass bin (spec 9.3.4.3.4)."""
        self.n_bins += 1
        off = (self.offset << 1) | self.read_bit()
        if off >= self.range:
            self.offset = off - self.range
            if self.trace is not None:
                self.trace.append(("y", 1, self.range, TRACE_LABEL[0]))
            return 1
        self.offset = off
        if self.trace is not None:
            self.trace.append(("y", 0, self.range, TRACE_LABEL[0]))
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        """end_of_slice_segment_flag / pcm_flag terminator (spec 9.3.4.3.5)."""
        self.n_bins += 1
        self.range -= 2
        if self.offset >= self.range:
            if self.trace is not None:
                self.trace.append(("t", 1, self.range, TRACE_LABEL[0]))
            return 1
        rng, off = self.range, self.offset
        while rng < 256:
            rng <<= 1
            off = (off << 1) | self.read_bit()
        self.range, self.offset = rng, off
        if self.trace is not None:
            self.trace.append(("t", 0, rng, TRACE_LABEL[0]))
        return 0

    # --- binarization helpers (spec 9.3.3) -------------------------------

    def decode_tu_bypass(self, c_max: int) -> int:
        """Truncated unary, all bypass bins."""
        for i in range(c_max):
            if self.decode_bypass() == 0:
                return i
        return c_max

    def decode_eg_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb, bypass (spec 9.3.3.3)."""
        num_zeros = 0
        while self.decode_bypass() == 1:
            num_zeros += 1
            if num_zeros > 32:
                raise ValueError("EGk runaway (corrupted stream)")
        value = (1 << num_zeros) - 1
        suffix = self.decode_bypass_bits(num_zeros + k)
        return (value << k) + suffix

    def align_for_bypass(self):
        """cabac bypass alignment (range ext only)."""
        self.range = 256

    def byte_offset(self) -> int:
        """Current read position in bytes (rounded up)."""
        return self.bytepos + (1 if self.bitcnt else 0)
