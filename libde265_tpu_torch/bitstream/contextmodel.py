"""Copy of libde265_tpu/bitstream/contextmodel.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

CABAC context model storage + initialization.

Capability counterpart of libde265/contextmodel.{h,cc}; the
initialization values are normative constants from H.265 spec clause 9.3.2.2
(Tables 9-5 .. 9-32) — identical in every conforming decoder.

Layout: one flat Python list of [pStateIdx, valMps] pairs; named slot offsets
below. initType = 0 for I slices, 1/2 for P/B (swapped by cabac_init_flag,
spec 9.3.2.2).
"""

# ---- per-element init values, indexed [initType][ctx] ---------------------
INIT_VALUES = {
    # element: ( (initType0...), (initType1...), (initType2...) )
    "sao_merge_flag": ((153,), (153,), (153,)),
    "sao_type_idx": ((200,), (185,), (160,)),
    "split_cu_flag": ((139, 141, 157), (107, 139, 126), (107, 139, 126)),
    "cu_transquant_bypass_flag": ((154,), (154,), (154,)),
    "cu_skip_flag": ((197, 185, 201), (197, 185, 201), (197, 185, 201)),
    "pred_mode_flag": ((149,), (149,), (134,)),
    "part_mode": ((184, 154, 139, 154), (154, 139, 154, 154), (154, 139, 154, 154)),
    "prev_intra_luma_pred_flag": ((184,), (154,), (183,)),
    "intra_chroma_pred_mode": ((63,), (152,), (152,)),
    "rqt_root_cbf": ((79,), (79,), (79,)),
    "merge_flag": ((110,), (110,), (154,)),
    "merge_idx": ((122,), (122,), (137,)),
    "inter_pred_idc": ((95, 79, 63, 31, 31), (95, 79, 63, 31, 31), (95, 79, 63, 31, 31)),
    "ref_idx": ((153, 153), (153, 153), (153, 153)),
    "abs_mvd_greater_flag": ((140, 198), (140, 198), (169, 198)),
    "mvp_flag": ((168,), (168,), (168,)),
    "split_transform_flag": ((153, 138, 138), (124, 138, 94), (224, 167, 122)),
    "cbf_luma": ((111, 141), (153, 111), (153, 111)),
    "cbf_chroma": ((94, 138, 182, 154, 154), (149, 107, 167, 154, 154), (149, 92, 167, 154, 154)),
    "transform_skip_flag": ((139, 139), (139, 139), (139, 139)),
    "last_sig_coeff_x_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93),
    ),
    "last_sig_coeff_y_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93),
    ),
    "coded_sub_block_flag": ((91, 171, 134, 141), (121, 140, 61, 154), (121, 140, 61, 154)),
    "sig_coeff_flag": (
        (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107,
         125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152,
         136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 141, 111),
        (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166,
         183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107,
         121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140),
        (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166,
         183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122,
         121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140, 140),
    ),
    "coeff_abs_level_greater1_flag": (
        (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152,
         140, 179, 166, 182, 140, 227, 122, 197),
        (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137,
         169, 194, 166, 167, 154, 167, 137, 182),
        (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122,
         169, 208, 166, 167, 154, 152, 167, 182),
    ),
    "coeff_abs_level_greater2_flag": (
        (138, 153, 136, 167, 152, 152),
        (107, 167, 91, 122, 107, 167),
        (107, 167, 91, 107, 107, 167),
    ),
    "cu_qp_delta_abs": ((154, 154), (154, 154), (154, 154)),
    # range-extension / 4:2:2+ elements (defaults; Main profile never decodes them)
    "cu_chroma_qp_offset_flag": ((154,), (154,), (154,)),
    "cu_chroma_qp_offset_idx": ((154,), (154,), (154,)),
    "log2_res_scale_abs_plus1": ((154,) * 8, (154,) * 8, (154,) * 8),
    "res_scale_sign_flag": ((154, 154), (154, 154), (154, 154)),
    "explicit_rdpcm_flag": ((139, 139), (139, 139), (139, 139)),
    "explicit_rdpcm_dir_flag": ((139, 139), (139, 139), (139, 139)),
}

# stable element ordering + flat offsets
_ORDER = list(INIT_VALUES.keys())
OFFSETS = {}
_off = 0
for _name in _ORDER:
    OFFSETS[_name] = _off
    _off += len(INIT_VALUES[_name][0])
NUM_CONTEXTS = _off


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def init_context(init_value: int, qp: int):
    """Spec 9.3.2.2: derive (pStateIdx, valMps) from the 8-bit init value."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = _clip3(1, 126, ((slope * _clip3(0, 51, qp)) >> 4) + offset)
    if pre <= 63:
        return [63 - pre, 0]
    return [pre - 64, 1]


class ContextModelTable:
    """Flat table of [pStateIdx, valMps] context states with named access.

    Carries the persistent-Rice StatCoeff state (range extension, spec
    9.3.2.3) alongside the models so WPP/dependent-slice snapshot and
    restore synchronize it together with the context variables. The
    reference keeps StatCoeff in its thread_context and zeroes it in
    initialize_CABAC_models (slice.cc:1507-1517)."""

    __slots__ = ("models", "stat_coeff")

    def __init__(self):
        self.models = [[0, 0] for _ in range(NUM_CONTEXTS)]
        self.stat_coeff = [0, 0, 0, 0]

    def init_states(self, init_type: int, qp: int):
        for name in _ORDER:
            vals = INIT_VALUES[name][init_type]
            base = OFFSETS[name]
            for i, iv in enumerate(vals):
                self.models[base + i] = init_context(iv, qp)
        self.stat_coeff = [0, 0, 0, 0]

    def at(self, name: str, idx: int = 0):
        return self.models[OFFSETS[name] + idx]

    def copy(self):
        t = ContextModelTable.__new__(ContextModelTable)
        t.models = [m[:] for m in self.models]
        t.stat_coeff = list(self.stat_coeff)
        return t
