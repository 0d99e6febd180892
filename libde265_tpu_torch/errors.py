"""Copy of libde265_tpu/errors.py (the port keeps its own copies of the
host modules and imports nothing of the JAX package).

Typed error / warning taxonomy + bounded warning queue.

Capability counterpart of the de265_error codes and the decoder warning
queue (libde265/de265.h:53-138, decctx error_queue
decctx.cc:2226-2281): non-fatal problems found during decode are queued as
typed codes, deduplicated for the once-only class, bounded, and surfaced
through Decoder.get_warning() / the `warnings` string list.
"""
import enum


class DecodeError(enum.IntEnum):
    OK = 0
    NO_SUCH_FILE = 1
    COEFFICIENT_OUT_OF_IMAGE_BOUNDS = 2
    CHECKSUM_MISMATCH = 3
    CTB_OUTSIDE_IMAGE_AREA = 4
    OUT_OF_MEMORY = 5
    CANNOT_START_THREADPOOL = 6
    LIBRARY_INITIALIZATION_FAILED = 7
    WAITING_FOR_INPUT = 8
    IMAGE_BUFFER_FULL = 9


class Warning(enum.IntEnum):
    """Warning codes (taxonomy parity with de265.h:110-138)."""
    END_OF_STREAM = 100
    PREMATURE_END_OF_SLICE_SEGMENT = 101
    INCORRECT_ENTRY_POINT_OFFSET = 102
    CTB_OUTSIDE_IMAGE_AREA = 103
    SPS_HEADER_INVALID = 104
    PPS_HEADER_INVALID = 105
    SLICEHEADER_INVALID = 106
    INCORRECT_MOTION_VECTOR_SCALING = 107
    NONEXISTING_PPS_REFERENCED = 108
    NONEXISTING_SPS_REFERENCED = 109
    BOTH_PREDFLAGS_ZERO = 110
    NONEXISTING_REFERENCE_PICTURE_ACCESSED = 111
    NUMMVP_NOT_EQUAL_TO_NUMMVQ = 112
    NUMBER_OF_SHORT_TERM_REF_PIC_SETS_OUT_OF_RANGE = 113
    SHORT_TERM_REF_PIC_SET_OUT_OF_RANGE = 114
    FAULTY_REFERENCE_PICTURE_LIST = 115
    EOSS_BIT_NOT_SET = 116
    MAX_NUM_REF_PICS_EXCEEDED = 117
    INVALID_CHROMA_FORMAT = 118
    SLICE_SEGMENT_ADDRESS_INVALID = 119
    DEPENDENT_SLICE_WITH_ADDRESS_ZERO = 120
    NUMBER_OF_THREADS_LIMITED_TO_MAXIMUM = 121
    NON_EXISTING_LT_REFERENCE_CANDIDATE_IN_SLICE_HEADER = 122
    CANNOT_APPLY_SAO_OUT_OF_IMAGE = 123
    SPS_MISSING_CANNOT_DECODE_SEI = 124
    COLLOCATED_MOTION_VECTOR_OUTSIDE_IMAGE_AREA = 125
    PCM_BITDEPTH_TOO_LARGE = 126
    REFERENCE_IMAGE_BIT_DEPTH_DOES_NOT_MATCH = 127
    REFERENCE_IMAGE_SIZE_DOES_NOT_MATCH = 128
    CHROMA_OF_CURRENT_IMAGE_DOES_NOT_MATCH_SPS = 129
    BIT_DEPTH_OF_CURRENT_IMAGE_DOES_NOT_MATCH_SPS = 130
    REFERENCE_IMAGE_CHROMA_FORMAT_DOES_NOT_MATCH = 131
    INVALID_SLICE_HEADER_INDEX_ACCESS = 132
    # additions beyond the reference taxonomy
    CHECKSUM_MISMATCH = 150
    NAL_PARSING_ERROR = 151
    SLICE_DATA_CORRUPTED = 152
    DPB_FULL_PICTURE_DROPPED = 153
    RASL_PICTURE_SKIPPED = 154
    VPS_HEADER_INVALID = 155


# warnings that are reported only once per decoder instance
# (reference: add_warning(..., once), decctx.cc:2243-2258)
ONCE = {
    Warning.NUMBER_OF_THREADS_LIMITED_TO_MAXIMUM,
    Warning.INCORRECT_ENTRY_POINT_OFFSET,
    Warning.RASL_PICTURE_SKIPPED,
}


class WarningQueue:
    """Bounded FIFO of Warning codes with once-only dedup."""

    MAX = 32

    def __init__(self):
        self.queue = []
        self._seen_once = set()
        self.messages = []    # readable log (unbounded cap below)

    def add(self, code: Warning, detail: str = ""):
        if code in ONCE:
            if code in self._seen_once:
                return
            self._seen_once.add(code)
        if len(self.queue) < self.MAX:
            self.queue.append(code)
        if len(self.messages) < 256:
            self.messages.append(f"{code.name}{': ' + detail if detail else ''}")

    def get(self):
        """Pop the oldest warning code, or None (de265_get_warning)."""
        if not self.queue:
            return None
        return self.queue.pop(0)

    def clear(self):
        self.queue.clear()
        self.messages.clear()
        self._seen_once.clear()
