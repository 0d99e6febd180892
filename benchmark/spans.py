"""Spans of the traced run, taken from the benchmark's own code around
the calls into the program's layers (the program records none of these
itself yet):

  drive        every call of the push API (client.Client._call)
  parse        libde265_tpu_torch.native_frontend.NativeFrontend.parse
  reconstruct  libde265_tpu_torch.api._decode_plans (packing, launches,
               synchronise, download of a segment's pictures)
  pack         DeviceStreamDecoder._pack (a label for the trace only)

Each span adds its seconds to the current request's record and, where
the profiler runs, is a record_function range "bench.<name>" that the
trace reader uses to say what the host was doing in each idle gap of the
device. The decoder that _decode_plans returns hands over its
pack_seconds counter (host seconds spent packing plans) to the record.
Only the traced run installs them.
"""
import time


class _Span:
    __slots__ = ("probe", "name", "t0", "rf")

    def __init__(self, probe, name):
        self.probe, self.name = probe, name

    def __enter__(self):
        self.rf = self.probe.record_function(f"bench.{self.name}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        rec = self.probe.rec
        if rec is not None:
            rec.spans[self.name] = rec.spans.get(self.name, 0.0) + dt
        return False


class Probe:
    def __init__(self):
        from torch.profiler import record_function
        self.record_function = record_function
        self.rec = None             # the request being driven
        self._undo = []

    def span(self, name):
        return _Span(self, name)

    def install(self):
        """Wrap the program's parse, reconstruct and pack entries."""
        from libde265_tpu_torch import api, native_frontend
        from libde265_tpu_torch.device_stream import DeviceStreamDecoder
        probe = self

        def patch(owner, attr, make):
            orig = getattr(owner, attr)
            setattr(owner, attr, make(orig))
            self._undo.append((owner, attr, orig))

        def parse(orig):
            def wrapped(*a, **kw):
                with probe.span("parse"):
                    return orig(*a, **kw)
            return wrapped

        def decode_plans(orig):
            def wrapped(*a, **kw):
                with probe.span("reconstruct"):
                    out = orig(*a, **kw)
                if probe.rec is not None:
                    probe.rec.pack_s += getattr(out[1], "pack_seconds", 0.0)
                return out
            return wrapped

        def pack(orig):
            def wrapped(*a, **kw):
                with probe.record_function("bench.pack"):
                    return orig(*a, **kw)
            return wrapped

        patch(native_frontend.NativeFrontend, "parse", parse)
        patch(api, "_decode_plans", decode_plans)
        patch(DeviceStreamDecoder, "_pack", pack)

    def uninstall(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
