"""The client loop: drives the push API of libde265_tpu_torch.api with
the generator's requests and records, for every picture returned, when
the push that delivered the last byte of its access unit began and when
get_next_picture returned it.

One request: new_decoder() (decoder "per_request") or reset() (decoder
"shared_reset"); then for each push, push_data() followed by decode()
calls, each followed by a drain of get_next_picture(), until decode()
waits for input; then flush_data() and the same decode-and-drain until
decode() ends. A request's k-th returned picture is the k-th access
unit's: the configurations state output order equal to decode order.
"""
import time
import traceback
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

from . import generator

_NO_SPAN = nullcontext()


@dataclass
class Picture:
    t_due: float        # perf_counter as the push of its AU's last byte began
    t_out: float        # perf_counter when get_next_picture returned it
    planes: list        # its planes (host arrays), kept for the check


@dataclass
class RequestRecord:
    index: int
    pictures: tuple             # expected: decode-order indices
    t_start: float = 0.0
    t_end: float = 0.0
    returned: list = field(default_factory=list)   # Picture
    profiled: bool = False
    error: str = None
    spans: dict = field(default_factory=dict)      # span -> seconds
    pack_s: float = 0.0         # the decoders' pack_seconds (traced run)
    batches: list = field(default_factory=list)    # pictures per decode()
                                                   # call that made any


class Client:
    """One client of one decoder kind on `device`. `api` is the module
    libde265_tpu_torch.api; `probe` times the API calls (a traced run's
    spans.Probe) or is None."""

    def __init__(self, api, device, mix, data, probe=None):
        self.api, self.device, self.mix, self.probe = api, device, mix, \
            probe
        self.prefix = generator.prefix(data, mix)
        self.dec = None             # the shared decoder ("shared_reset")
        self.stats = {}             # decoders' route counters, summed
        self.errors = []

    # ---------------------------------------------------------------- API
    def _call(self, fn, *args, **kw):
        span = self.probe.span("drive") if self.probe else _NO_SPAN
        with span:
            return fn(*args, **kw)

    def open(self):
        """Set-up of a shared decoder: its parameter sets pushed once."""
        if self.mix["decoder"] == "shared_reset":
            self.dec = self.api.new_decoder(device=self.device)
            if self.prefix:
                self.api.push_data(self.dec, self.prefix)
            self.api.flush_data(self.dec)
            while self.api.decode(self.dec):
                pass

    def close(self):
        if self.dec is not None:
            self._add_stats(self.dec)
            self.dec = None

    def _add_stats(self, dec):
        for k, v in getattr(dec, "stats", {}).items():
            if isinstance(v, (int, float)):
                self.stats[k] = self.stats.get(k, 0) + v

    # ------------------------------------------------------------ request
    def run(self, req, sizes, rec):
        """Drive one request; fills `rec`. An exception of the program is
        recorded in rec.error (its pictures then count as missing) and the
        loop goes on."""
        if self.probe:
            self.probe.rec = rec
        rec.t_start = time.perf_counter()
        try:
            self._run(req, sizes, rec)
        except Exception:
            rec.error = traceback.format_exc()
            self.errors.append(rec.error)
        rec.t_end = time.perf_counter()
        if self.probe:
            self.probe.rec = None

    def _run(self, req, sizes, rec):
        api = self.api
        per_request = self.mix["decoder"] == "per_request"
        if per_request:
            dec = self._call(api.new_decoder, device=self.device)
        else:
            dec = self.dec
            self._call(api.reset, dec)
        due = []
        ends = deque(req.au_ends)
        off = 0
        for n in sizes:
            chunk = req.data[off:off + n]
            t = time.perf_counter()
            self._call(api.push_data, dec, chunk)
            off += n
            while ends and ends[0] <= off:
                ends.popleft()
                due.append(t)
            self._decode_and_drain(dec, rec, due)
        self._call(api.flush_data, dec)
        self._decode_and_drain(dec, rec, due)
        if per_request:
            self._add_stats(dec)

    def _decode_and_drain(self, dec, rec, due):
        api = self.api
        while True:
            more = self._call(api.decode, dec)
            got = 0
            while True:
                pic = self._call(api.get_next_picture, dec)
                if pic is None:
                    break
                t = time.perf_counter()
                k = len(rec.returned)
                rec.returned.append(Picture(
                    due[k] if k < len(due) else rec.t_start, t, pic.planes))
                got += 1
            if got:
                rec.batches.append(got)
            if not more:
                return
