"""The readers of the program's own spans (benchmark/program_spans.py) on
a traced run of a small stream through the client on device="cpu":
each reads a number, and the ones that have a counterpart among the
benchmark's own wrappers read what it reads."""
import sys

import pytest

from benchmark import run as bench_run, spec
from benchmark.record import RunRecord
from bench_cells import ROOT, small_cell

READERS = ("program_drive_ms_per_frame", "program_release_batch_frames",
           "program_parse_ms_per_frame", "program_pack_ms_per_frame",
           "upload_ms_per_frame", "sync_wait_ms_per_frame",
           "download_ms_per_frame", "enqueue_ms_per_frame",
           "reconstruct_self_ms_per_frame")


def _read(name, run):
    return spec.reader(ROOT, name).read(run)


@pytest.fixture(scope="module", params=["transcode", "keyframes"])
def traced(request):
    cell = small_cell(mix=request.param)
    run, checks, *_ = bench_run.run_cell(ROOT, cell, 2 ** 31 + 11, 1.0, 1,
                                         "cpu")
    assert checks["planes_wrong"] == 0 and checks["pictures_missing"] == 0
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_reads(traced, name):
    v = _read(name, traced)
    assert v is not None and v >= 0, name


def test_readers_match_the_wrappers(traced):
    assert _read("program_release_batch_frames", traced) == \
        _read("release_batch_frames", traced)
    # pack_seconds is the sum of the pack spans
    assert _read("program_pack_ms_per_frame", traced) == pytest.approx(
        _read("pack_ms_per_frame", traced), rel=1e-9)
    # the program's spans lie inside the benchmark's wrappers
    assert 0 < _read("program_parse_ms_per_frame", traced) <= \
        _read("parse_ms_per_frame", traced)
    assert 0 < _read("program_drive_ms_per_frame", traced)


def test_every_reader_has_an_entry():
    bench = spec.load_benchmark(ROOT)
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert names[name]["source"] in ("program_span", "program_counter")
        assert names[name]["workloads"] == ["ld4k_light.transcode",
                                            "gop1080p.keyframes"]


def test_nothing_to_read(traced, monkeypatch):
    empty = RunRecord(config={}, mix={}, seed=1, setup_s=1.0)
    for name in READERS:
        assert _read(name, empty) is None, name
    # a program without the telemetry module (an older checkout)
    monkeypatch.setitem(sys.modules, "libde265_tpu_torch.telemetry", None)
    for name in READERS:
        assert _read(name, traced) is None, name


def test_dropped_spans_inside_the_window(traced, monkeypatch):
    from libde265_tpu_torch import telemetry
    recs = telemetry.records()
    monkeypatch.setattr(telemetry, "dropped", lambda: 1)
    # the oldest span kept ended after the first request began: a span
    # that ended before it may have started in a request
    first = min(r.t_start for r in traced.unprofiled())
    assert recs[0].t1 < first * 1e9 or \
        _read("upload_ms_per_frame", traced) is None
    monkeypatch.setattr(telemetry, "records",
                        lambda: [s for s in recs if s.t1 >= first * 1e9])
    assert _read("upload_ms_per_frame", traced) is None
