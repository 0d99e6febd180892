"""The metric readers on synthetic records: the tail over every picture
and the rate over the whole window, a stall included."""
import pytest

from benchmark import spec
from benchmark.client import Picture, RequestRecord
from benchmark.record import RunRecord
from bench_cells import ROOT


def _read(name, run):
    return spec.reader(ROOT, name).read(run)


def _run_with_stall():
    """100 requests of one picture over a 12 s window: 99 come out 50 ms
    after their push, one after a 2 s stall; then nothing for the last
    4.95 s of the window, which still counts."""
    reqs, t = [], 0.0
    for i in range(100):
        r = RequestRecord(i, (i,))
        lat = 2.0 if i == 40 else 0.05
        r.returned.append(Picture(t, t + lat, []))
        r.batches.append(1)
        r.spans = {"drive": 0.04, "parse": 0.01, "reconstruct": 0.02}
        r.pack_s = 0.005
        reqs.append(r)
        t += lat
    return RunRecord(config={}, mix={}, seed=1, setup_s=7.5,
                     window_s=12.0, cpu_s=3.0, requests=reqs)


def test_rate_over_the_whole_window():
    assert _read("decode_fps", _run_with_stall()) == pytest.approx(100 / 12)


def test_p95_over_all_pictures():
    run = _run_with_stall()
    # nearest rank: the 95th of 100 sorted latencies, all 50 ms but one
    assert _read("picture_latency_p95_ms", run) == pytest.approx(50.0)
    for r in run.requests[:6]:
        r.returned[0].t_out = r.returned[0].t_due + 1.5
    assert _read("picture_latency_p95_ms", run) == pytest.approx(1500.0)


def test_cpu_setup_and_batches():
    run = _run_with_stall()
    assert _read("host_cpu_ms_per_frame", run) == pytest.approx(30.0)
    assert _read("setup_s", run) == 7.5
    run.requests[0].batches = [33]
    run.requests[1].batches = []
    assert _read("release_batch_frames", run) == pytest.approx(
        (33 + 98) / 99)


def test_spans_leave_out_the_profiled_stretch():
    run = _run_with_stall()
    assert _read("drive_ms_per_frame", run) == pytest.approx(10.0)
    assert _read("parse_ms_per_frame", run) == pytest.approx(10.0)
    assert _read("pack_ms_per_frame", run) == pytest.approx(5.0)
    for r in run.requests[10:20]:
        r.profiled = True
        r.spans = {"drive": 9.0, "parse": 1.0, "reconstruct": 1.0}
        r.pack_s = 1.0
    assert _read("drive_ms_per_frame", run) == pytest.approx(10.0)
    assert _read("pack_ms_per_frame", run) == pytest.approx(5.0)


def test_nothing_to_read():
    run = RunRecord(config={}, mix={}, seed=1, setup_s=1.0)
    for name in ("decode_fps", "picture_latency_p95_ms",
                 "host_cpu_ms_per_frame", "drive_ms_per_frame",
                 "release_batch_frames", "parse_ms_per_frame",
                 "pack_ms_per_frame", "launches_per_frame",
                 "kernels_roofline", "device_idle_pct"):
        assert _read(name, run) is None, name


def test_every_metric_has_a_reader():
    bench = spec.load_benchmark(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(ROOT, m["name"]).read)
