"""The port's telemetry (libde265_tpu_torch.telemetry): the span log's
ids, bound and totals, the spans a push decode on the CPU leaves, and
the profiler ranges that share the log's clock."""
import gc
import json
import os
import threading

import pytest
import torch

from libde265_tpu_torch import api, telemetry

DATA = os.path.join(os.path.dirname(__file__), "data")


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _clear():
    telemetry.clear()
    yield
    telemetry.clear()


def _push_decode(data, chunk=997, **kw):
    """The pictures of `data` through the push API on the CPU, pushed in
    `chunk`-byte pieces with a decode-and-drain after each."""
    dec = api.new_decoder(device="cpu", **kw)
    pics = []

    def drain():
        while True:
            more = api.decode(dec)
            while True:
                p = api.get_next_picture(dec)
                if p is None:
                    break
                pics.append(p)
            if not more:
                return

    for i in range(0, len(data), chunk):
        api.push_data(dec, data[i:i + chunk])
        drain()
    api.flush_data(dec)
    drain()
    return dec, pics


def test_nested_spans_parent_and_request_ids():
    with telemetry.span("outer", request=7) as a:
        with telemetry.span("mid", n=3) as b:
            with telemetry.span("inner") as c:
                pass
        with telemetry.span("other", request=9) as d:
            pass
    with telemetry.span("alone") as e:
        pass
    assert a.parent == 0 and b.parent == a.id and c.parent == b.id
    assert d.parent == a.id and e.parent == 0
    assert (a.request, b.request, c.request, d.request, e.request) == \
        (7, 7, 7, 9, 0)
    assert len({a.id, b.id, c.id, d.id, e.id}) == 5
    # the log holds them in the order they ended
    assert [s.name for s in telemetry.records()] == \
        ["inner", "mid", "other", "outer", "alone"]
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1
    assert b.n == 3 and b.seconds == (b.t1 - b.t0) / 1e9


def test_ring_bound_and_dropped_count():
    assert telemetry.CAPACITY >= 65536
    extra = 10
    for i in range(telemetry.CAPACITY + extra):
        with telemetry.span("s", n=1):
            pass
    recs = telemetry.records()
    assert len(recs) == telemetry.CAPACITY
    assert telemetry.dropped() == extra
    # the oldest went first; the totals count every span
    assert recs[0].id == recs[-1].id - telemetry.CAPACITY + 1
    count, secs, n = telemetry.totals()["s"]
    assert count == n == telemetry.CAPACITY + extra and secs > 0
    telemetry.clear()
    assert telemetry.records() == [] and telemetry.dropped() == 0 \
        and telemetry.totals() == {}


def test_span_that_raises_is_logged():
    with pytest.raises(KeyError):
        with telemetry.span("fails"):
            raise KeyError("x")
    with telemetry.span("after") as s:
        pass
    assert [r.name for r in telemetry.records()] == ["fails", "after"]
    assert s.parent == 0


def test_threads_keep_their_own_stacks_and_totals_add_up():
    """More threads than cores, switching as often as the interpreter
    allows, each nesting spans: no span is lost from the totals or the
    ring, and each thread's spans nest among themselves only."""
    import sys
    nthreads, each = 2 * (os.cpu_count() or 1) + 1, 500
    seen = [[] for _ in range(nthreads)]

    def work(k):
        for _ in range(each):
            with telemetry.span("outer", n=1) as a:
                with telemetry.span("inner", n=2) as b:
                    pass
            seen[k].append((a, b))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.span("main") as m:
            ts = [threading.Thread(target=work, args=(k,))
                  for k in range(nthreads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    total = nthreads * each
    tot = telemetry.totals()
    assert tot["outer"][0] == tot["inner"][0] == total
    assert tot["outer"][2] == total and tot["inner"][2] == 2 * total
    assert tot["main"][0] == 1 and m.parent == 0
    assert len(telemetry.records()) == 2 * total + 1
    assert telemetry.dropped() == 0
    for pairs in seen:
        assert all(a.parent == 0 and b.parent == a.id and a.request == 0
                   for a, b in pairs)


def test_push_decode_spans():
    """Two copies of p_mv back to back: two segments (IDR to IDR), four
    device frames each."""
    data = _load("p_mv")
    dec, pics = _push_decode(data + data)
    assert len(pics) == 8
    recs = telemetry.records()
    names = [s.name for s in recs]
    by_id = {s.id: s for s in recs}
    assert names.count("segment") == 2
    assert names.count("parse") == 2 and names.count("param_sets") == 2
    assert names.count("decode_plans") == 2
    assert names.count("stream_setup") == 2
    assert names.count("frame") == dec.stats["n_frames"] == 8
    assert names.count("sync") == 2
    assert sum(s.n for s in recs if s.name == "segment") == 8
    assert sum(s.n for s in recs if s.name == "parse") == 8
    # api.decode's n: the pictures each call added to the output queue
    decodes = [s for s in recs if s.name == "api.decode"]
    assert sum(s.n for s in decodes) == len(pics)
    assert all(s.request == dec.serial for s in recs
               if s.name.startswith("api."))
    parents = {"parse.slices": "parse", "parse.extract": "parse",
               "parse": "segment", "param_sets": "segment",
               "decode_plans": "segment", "stream_setup": "decode_plans",
               "sync": "decode_plans", "frame": "decode_plans",
               "grids": "frame", "mc": "frame", "residual": "frame",
               "deblock": "frame", "sao": "frame", "insert": "frame",
               "segment": "api.decode"}
    for s in recs:
        if s.name in parents:
            assert by_id[s.parent].name == parents[s.name], s
        # every span of the decode runs under one of its API calls
        assert s.request == dec.serial, s
    # the upload and download spans count bytes: 4 * 64 x 64 4:2:0
    assert sum(s.n for s in recs if s.name == "download") >= \
        8 * 64 * 64 * 3 // 2
    assert sum(s.n for s in recs if s.name == "upload") > 0


def test_two_decoders_two_request_ids():
    data = _load("p_mv")
    a, _ = _push_decode(data)
    b, _ = _push_decode(data)
    assert a.serial != b.serial
    reqs = {s.request for s in telemetry.records()
            if s.name == "decode_plans"}
    assert reqs == {a.serial, b.serial}


def test_pack_seconds_is_the_sum_of_pack_spans():
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    plans = api._parse(_load("p_mv"))
    dec = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    telemetry.clear()
    dec.decode_all()
    packs = [s for s in telemetry.records() if s.name == "pack"]
    assert packs and dec.pack_seconds == pytest.approx(
        sum(s.seconds for s in packs), rel=1e-12)


def test_python_parse_seconds_are_the_slice_parse_spans():
    dec, pics = _push_decode(_load("p_mv"), parse="python")
    assert len(pics) == 4
    spans = [s for s in telemetry.records() if s.name == "slice_parse"]
    assert len(spans) >= 4
    assert dec.stats["parse_s"] == pytest.approx(
        sum(s.seconds for s in spans), rel=1e-12)


def test_no_record_function_without_a_profiler(monkeypatch):
    rf = torch.autograd.profiler.record_function
    entered = []
    orig = rf.__enter__

    def counting(self):
        entered.append(self.name)
        return orig(self)

    monkeypatch.setattr(rf, "__enter__", counting)
    _push_decode(_load("p_mv"))
    assert entered == []
    assert telemetry.totals()["frame"][0] == 4
    # the counter does count where a profiler records
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("probe"):
            pass
    assert entered == ["de265.probe"]


def _profiled_decode(data, path):
    """(log spans, "de265.*" host ranges of the trace), each sorted by
    start, of a push decode of `data` under torch.profiler (CPU
    activity). A first span warms the profiler's ranges up and is left
    out of both."""
    from torch.profiler import ProfilerActivity, profile
    telemetry.clear()
    gc.collect()
    gc.disable()          # a collection inside a span is not the clock
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.span("warm"):
                pass
            _push_decode(data)
    finally:
        gc.enable()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(telemetry.PREFIX)
              and e["name"] != telemetry.PREFIX + "warm"]
    recs = sorted((s for s in telemetry.records() if s.name != "warm"),
                  key=lambda s: s.t0)
    ev.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    return recs, ev


def test_profiler_ranges_share_the_log_clock(tmp_path):
    """Under torch.profiler (CPU activity) every span of a push decode is
    also a "de265.<name>" range of the same length (50 us), and the
    ranges' starts are the log's shifted by one constant (100 us). A
    run the machine's scheduler interrupts between a span's start and
    its range's can miss the bounds, so the decode gets five tries."""
    data = _load("p_mv")
    for attempt in range(5):
        recs, ev = _profiled_decode(data, tmp_path / f"trace{attempt}.json")
        assert len(recs) > 50 and len(ev) == len(recs)
        assert [e["name"] for e in ev] == \
            [telemetry.PREFIX + s.name for s in recs]
        dur = [abs(float(e["dur"]) - (s.t1 - s.t0) / 1e3)
               for s, e in zip(recs, ev)]
        off = [float(e["ts"]) - s.t0 / 1e3 for s, e in zip(recs, ev)]
        if max(dur) <= 50 and max(off) - min(off) <= 200:
            return
    pytest.fail(f"last try: durations differ by up to {max(dur):.1f} us, "
                f"offsets spread over {max(off) - min(off):.1f} us")
