"""Copy of libde265_tpu/encoder/rate_estim.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

CABAC rate estimation without bitstream output.

Capability counterpart of reference libde265/cabac.{h,cc}
CABAC_encoder_estim / CABAC_encoder_estim_constant (the encoder's RDO rate
models): same encode_* interface as CabacEncoder, but accumulates Q15
fractional bits from a per-state entropy table instead of producing bytes.
Table generated by tools/gen_entropy_table.py (counterpart of
tools/gen-entropy-table.cc, replay method).
"""
from ..bitstream.cabac import TRANS_IDX_LPS

# (MPS bits, LPS bits) per state, Q15 fixed point
ENTROPY_TABLE = [
    (0x07d0e, 0x08275),  # state 0: 0.9770 / 1.0192
    (0x0771d, 0x086dc),  # state 1: 0.9306 / 1.0536
    (0x0700d, 0x09312),  # state 2: 0.8754 / 1.1490
    (0x069d4, 0x09c8b),  # state 3: 0.8268 / 1.2230
    (0x062d7, 0x0a2a3),  # state 4: 0.7722 / 1.2706
    (0x05bf4, 0x0ae14),  # state 5: 0.7184 / 1.3600
    (0x05611, 0x0b70a),  # state 6: 0.6724 / 1.4300
    (0x05120, 0x0c027),  # state 7: 0.6338 / 1.5012
    (0x04be7, 0x0ccb9),  # state 8: 0.5930 / 1.5994
    (0x04786, 0x0d52b),  # state 9: 0.5588 / 1.6654
    (0x042a9, 0x0de2e),  # state 10: 0.5208 / 1.7358
    (0x03f4f, 0x0e44d),  # state 11: 0.4946 / 1.7836
    (0x03aac, 0x0f412),  # state 12: 0.4584 / 1.9068
    (0x037ce, 0x0fc43),  # state 13: 0.4360 / 1.9708
    (0x034b5, 0x1022d),  # state 14: 0.4118 / 2.0170
    (0x031ca, 0x10d56),  # state 15: 0.3890 / 2.1042
    (0x02e48, 0x11b3d),  # state 16: 0.3616 / 2.2128
    (0x02be7, 0x12083),  # state 17: 0.3430 / 2.2540
    (0x029a6, 0x12916),  # state 18: 0.3254 / 2.3210
    (0x02779, 0x135d6),  # state 19: 0.3084 / 2.4206
    (0x02559, 0x13e2e),  # state 20: 0.2918 / 2.4858
    (0x02318, 0x144dd),  # state 21: 0.2742 / 2.5380
    (0x021a9, 0x150aa),  # state 22: 0.2630 / 2.6302
    (0x01f4f, 0x15c6a),  # state 23: 0.2446 / 2.7220
    (0x01e00, 0x162b0),  # state 24: 0.2344 / 2.7710
    (0x01c43, 0x16d6a),  # state 25: 0.2208 / 2.8548
    (0x01a92, 0x17a85),  # state 26: 0.2076 / 2.9572
    (0x0193d, 0x18041),  # state 27: 0.1972 / 3.0020
    (0x017f6, 0x18752),  # state 28: 0.1872 / 3.0572
    (0x01645, 0x19412),  # state 29: 0.1740 / 3.1568
    (0x01532, 0x19f0d),  # state 30: 0.1656 / 3.2426
    (0x01446, 0x1a45a),  # state 31: 0.1584 / 3.2840
    (0x01339, 0x1b3f7),  # state 32: 0.1502 / 3.4060
    (0x011ff, 0x1bcf4),  # state 33: 0.1406 / 3.4762
    (0x01119, 0x1c367),  # state 34: 0.1336 / 3.5266
    (0x0105b, 0x1d034),  # state 35: 0.1278 / 3.6266
    (0x00fb1, 0x1d6f6),  # state 36: 0.1226 / 3.6794
    (0x00ef9, 0x1df83),  # state 37: 0.1170 / 3.7462
    (0x00e0d, 0x1e645),  # state 38: 0.1098 / 3.7990
    (0x00d2f, 0x1f90f),  # state 39: 0.1030 / 3.9458
    (0x00cc6, 0x1fd91),  # state 40: 0.0998 / 3.9810
    (0x00c50, 0x203ea),  # state 41: 0.0962 / 4.0306
    (0x00b92, 0x20f69),  # state 42: 0.0904 / 4.1204
    (0x00b0f, 0x21dd9),  # state 43: 0.0864 / 4.2332
    (0x00a78, 0x22404),  # state 44: 0.0818 / 4.2814
    (0x00a36, 0x22a29),  # state 45: 0.0798 / 4.3294
    (0x009a0, 0x23745),  # state 46: 0.0752 / 4.4318
    (0x00930, 0x24205),  # state 47: 0.0718 / 4.5158
    (0x008ef, 0x246e9),  # state 48: 0.0698 / 4.5540
    (0x00872, 0x252e4),  # state 49: 0.0660 / 4.6476
    (0x00837, 0x25d0e),  # state 50: 0.0642 / 4.7270
    (0x007d5, 0x264bc),  # state 51: 0.0612 / 4.7870
    (0x00793, 0x26816),  # state 52: 0.0592 / 4.8132
    (0x0072b, 0x27d91),  # state 53: 0.0560 / 4.9810
    (0x006f6, 0x28161),  # state 54: 0.0544 / 5.0108
    (0x0066c, 0x28944),  # state 55: 0.0502 / 5.0724
    (0x00624, 0x29758),  # state 56: 0.0480 / 5.1824
    (0x005f6, 0x2a2ca),  # state 57: 0.0466 / 5.2718
    (0x005e9, 0x2a56d),  # state 58: 0.0462 / 5.2924
    (0x0059b, 0x2ad21),  # state 59: 0.0438 / 5.3526
    (0x00559, 0x2bb98),  # state 60: 0.0418 / 5.4656
    (0x0052b, 0x2c56d),  # state 61: 0.0404 / 5.5424
    (0x00504, 0x2cd42),  # state 62: 0.0392 / 5.6036
    (0x002c3, 0x3b631),  # state 63: 0.0216 / 7.4234
]


class CabacEstimator:
    """Accumulates estimated bits; context states advance exactly as in the
    real encoder so estimates track adaptation."""

    def __init__(self):
        self.frac_bits = 0   # Q15

    # --- bin "encoders" ---------------------------------------------------
    def encode_bin(self, ctx, b):
        state, mps = ctx[0], ctx[1]
        if b == mps:
            self.frac_bits += ENTROPY_TABLE[state][0]
            ctx[0] = state + 1 if state < 62 else state
        else:
            self.frac_bits += ENTROPY_TABLE[state][1]
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]

    def encode_bypass(self, b):
        self.frac_bits += 0x8000

    def encode_bypass_bits(self, v, n):
        self.frac_bits += n * 0x8000

    def encode_terminate(self, b):
        self.frac_bits += 0x8000  # coarse; terminate is rare

    def reset_engine(self):
        pass

    # --- binarizations (mirrors CabacEncoder) -----------------------------
    def encode_tu_bypass(self, v, c_max):
        self.frac_bits += min(v + 1, c_max) * 0x8000

    def encode_eg_bypass(self, v, k):
        nz = 0
        base = 0
        while v >= (base + (1 << (nz + k))):
            base += 1 << (nz + k)
            nz += 1
        self.frac_bits += (nz + 1 + nz + k) * 0x8000

    # --- result -----------------------------------------------------------
    @property
    def bits(self) -> float:
        return self.frac_bits / 0x8000

    def reset(self):
        self.frac_bits = 0


class CabacEstimatorConstant(CabacEstimator):
    """Context-constant variant (counterpart of CABAC_encoder_estim_constant,
    reference cabac.h:188-209): rates come from the current context states
    but the states do NOT adapt. Used for order-independent RD comparisons
    where many candidates are priced against the same context snapshot."""

    def encode_bin(self, ctx, b):
        state, mps = ctx[0], ctx[1]
        self.frac_bits += ENTROPY_TABLE[state][0 if b == mps else 1]
