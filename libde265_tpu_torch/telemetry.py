"""The port's telemetry: named spans of host work in a bounded log, with
totals per name.

    from . import telemetry
    with telemetry.span("pack", n=1) as s:
        ...
    s.seconds                    # the span's length, once it has ended

A span records its name; its start and end on time.perf_counter_ns()
(the clock of time.perf_counter, which callers time requests with); an
id; the id of the span it runs inside on the same thread (0 for none);
a request id, the serial number (next_request) of the push decoder
whose API call it runs under, taken from the enclosing span where not
given (0 outside any); and one integer n, whose meaning each span
states (frames, pictures, bytes). A span that ends goes into a ring of
CAPACITY records, which drops (and counts) the oldest when it is full,
and into its name's totals (count, seconds, n). records(), totals() and
dropped() read them; clear() empties them. The log is always on: a span
costs a few microseconds of host time at most.

While a torch profiler records (torch.autograd.profiler's own enabled
flag), each span also opens the record_function range "de265.<name>"
just inside its own start and end, so that the profiler's trace holds
it on the clock of the device's work; while none records, no
record_function is entered.
"""
import itertools
import threading
import time
from collections import deque

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16
PREFIX = "de265."

_ring = deque(maxlen=CAPACITY)
# per thread: its stack of open spans and its totals (name -> [count,
# ns, n]), so that logging a span takes no lock (deque.append is atomic)
_local = threading.local()
_threads = []                   # (thread, its totals) of live threads
_retired = {}                   # the totals of threads that have ended
_lock = threading.Lock()        # guards _threads and _retired
_ids = itertools.count(1)
_serials = itertools.count(1)


def _state():
    """This thread's (stack of open spans, totals)."""
    try:
        return _local.state
    except AttributeError:
        st = _local.state = ([], {})
        with _lock:
            for th, tots in [x for x in _threads if not x[0].is_alive()]:
                _threads.remove((th, tots))
                _add(_retired, tots)
            _threads.append((threading.current_thread(), st[1]))
        return st


def _add(into, tots):
    for k, (c, ns, n) in list(tots.items()):
        a = into.setdefault(k, [0, 0, 0])
        a[0] += c
        a[1] += ns
        a[2] += n


class Span:
    """One span: the context manager while it runs, the record after."""
    __slots__ = ("name", "t0", "t1", "id", "parent", "request", "n", "_rf",
                 "_st")

    def __init__(self, name, n=0, request=None):
        self.name, self.n, self.request = name, n, request

    def __enter__(self):
        self._st = st = _state()
        stack = st[0]
        if stack:
            outer = stack[-1]
            self.parent = outer.id
            if self.request is None:
                self.request = outer.request
        else:
            self.parent = 0
            if self.request is None:
                self.request = 0
        self.id = next(_ids)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(PREFIX + self.name)
            self.t0 = time.perf_counter_ns()
            self._rf.__enter__()
        else:
            self._rf = None
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.t1 = t1 = time.perf_counter_ns()
        stack, tots = self._st
        self._st = None
        stack.pop()
        _ring.append(self)
        tot = tots.get(self.name)
        if tot is None:
            tot = tots[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += t1 - self.t0
        tot[2] += self.n
        return False

    @property
    def seconds(self):
        return (self.t1 - self.t0) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"id={self.id}, parent={self.parent}, "
                f"request={self.request}, n={self.n})")


span = Span


def next_request():
    """A new request id: one per push decoder."""
    return next(_serials)


def records():
    """The logged spans, oldest end first (at most CAPACITY)."""
    return list(_ring)


def totals():
    """{name: (count, seconds, n)} over every span logged since the
    last clear(), dropped ones included."""
    out = {}
    with _lock:
        _add(out, _retired)
        for _, tots in _threads:
            _add(out, tots)
    return {k: (c, ns / 1e9, n) for k, (c, ns, n) in out.items()}


def dropped():
    """Spans logged since the last clear() that the ring no longer
    holds."""
    return sum(c for c, _, _ in totals().values()) - len(_ring)


def clear():
    with _lock:
        _ring.clear()
        _retired.clear()
        for _, tots in _threads:
            tots.clear()
