"""Copy of libde265_tpu/dpb.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Decoded picture buffer, POC computation, reference picture set marking and
reference list construction (spec 8.3.1, 8.3.2, 8.3.4).

Capability counterpart of libde265/dpb.{h,cc} and the POC/RPS
logic in decctx.cc:1350-1855.
"""
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bitstream import nal as nal_mod

# picture states
UNUSED = 0
SHORT_TERM = 1
LONG_TERM = 2


@dataclass
class DPBPicture:
    poc: int = 0
    state: int = UNUSED          # reference marking
    needed_for_output: bool = False
    pic_latency_count: int = 0
    plan: object = None          # FramePlan (metadata + motion field)
    planes: list = None          # reconstructed [Y,Cb,Cr]
    output_planes: list = None   # conformance-window cropped
    integrity: int = 0
    pic_output_flag: bool = True
    pts: object = None           # presentation timestamp (de265_PTS)

    def in_use(self):
        return self.state != UNUSED or self.needed_for_output


class DPB:
    """Fixed pool of picture slots + POC-sorted reorder/output queues
    (mirror of decoded_picture_buffer, dpb.h:32-116)."""

    def __init__(self, size=20):
        self.pics: List[DPBPicture] = [DPBPicture() for _ in range(size)]
        self.reorder: List[int] = []   # slot indices awaiting output, sorted by POC
        self.output_queue: List[int] = []

    def free_slot(self) -> int:
        for i, p in enumerate(self.pics):
            if not p.in_use():
                return i
        return -1

    def has_free(self) -> bool:
        return self.free_slot() >= 0

    def new_picture(self, poc) -> int:
        i = self.free_slot()
        if i < 0:
            raise RuntimeError("DPB full")
        self.pics[i] = DPBPicture(poc=poc, state=SHORT_TERM, needed_for_output=True)
        return i

    def index_with_poc(self, poc) -> int:
        # prefer long-term (reference behavior dpb.cc)
        for i, p in enumerate(self.pics):
            if p.state == LONG_TERM and p.poc == poc:
                return i
        for i, p in enumerate(self.pics):
            if p.state == SHORT_TERM and p.poc == poc:
                return i
        return -1

    def index_with_poc_lsb(self, poc_lsb, max_lsb, prefer_long_term=True) -> int:
        for want_lt in ((True, False) if prefer_long_term else (False,)):
            for i, p in enumerate(self.pics):
                if p.state == UNUSED:
                    continue
                if (p.state == LONG_TERM) != want_lt:
                    continue
                if (p.poc % max_lsb + max_lsb) % max_lsb == poc_lsb:
                    return i
        return -1

    def clear_references(self):
        for p in self.pics:
            p.state = UNUSED

    def drop_oldest_reference(self):
        """Last-resort slot recovery for over-referencing (corrupt) streams:
        unmark the lowest-POC reference so decode can continue."""
        cands = [i for i, p in enumerate(self.pics) if p.state != UNUSED]
        if not cands:
            return
        i = min(cands, key=lambda j: self.pics[j].poc)
        self.pics[i].state = UNUSED
        self.pics[i].needed_for_output = False
        if i in self.reorder:
            self.reorder.remove(i)

    def reset(self):
        """Drop all pictures and queues (de265_reset, decctx.cc:360-428)."""
        for i in range(len(self.pics)):
            self.pics[i] = DPBPicture()
        self.reorder.clear()
        self.output_queue.clear()

    def insert_reorder(self, idx):
        self.reorder.append(idx)
        self.reorder.sort(key=lambda i: self.pics[i].poc)

    def output_next(self):
        if not self.reorder:
            return
        idx = self.reorder.pop(0)
        self.pics[idx].needed_for_output = False
        # hold the object: the slot may be reused before the app pops it
        self.output_queue.append(self.pics[idx])

    def num_pictures_in_reorder(self):
        return len(self.reorder)

    def flush_reorder(self):
        while self.reorder:
            self.output_next()

    def pop_output(self) -> Optional[DPBPicture]:
        if not self.output_queue:
            return None
        return self.output_queue.pop(0)

    def peek_output(self) -> Optional[DPBPicture]:
        """Front of the output queue without removing it
        (de265_peek_next_picture)."""
        return self.output_queue[0] if self.output_queue else None
