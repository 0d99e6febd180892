"""A small stream through both clients on device="cpu" (the kernels'
plain PyTorch versions): the logic of a run, not its numbers."""
import os
import subprocess
import sys
import time

import pytest

from benchmark import run as bench_run, spec
from bench_cells import ROOT, small_cell


@pytest.mark.parametrize("mix,requests_pictures", [("transcode", 4),
                                                   ("keyframes", 1)])
def test_client_on_cpu(mix, requests_pictures):
    cell = small_cell(mix=mix)
    run, checks, att, failed, info = bench_run.run_cell(
        ROOT, cell, 2 ** 31 + 3, 1.0, 0, "cpu")
    assert checks == {"planes_wrong": 0, "pictures_missing": 0,
                      "pictures_extra": 0, "requests_failed": 0}
    assert failed == 0 and att == len(run.pictures) > 0
    assert all(len(r.returned) == requests_pictures for r in run.requests)
    assert run.window_s >= 1.0 and run.setup_s > 0 and run.cpu_s > 0
    assert all(p.t_out > p.t_due for p in run.pictures)
    assert run.stats["n_python_segments"] == 0
    # each request is one segment; p_mv has one IRAP picture, so either
    # mix warms up with one request
    assert run.stats["n_segments"] == len(run.requests) + 1
    bench = spec.load_benchmark(ROOT)
    for m in bench["end_to_end"]:
        assert spec.reader(ROOT, m["name"]).read(run) > 0, m["name"]
    batch = spec.reader(ROOT, "release_batch_frames").read(run)
    assert batch == requests_pictures


def test_picture_to_push_mapping():
    """A picture is timed from the start of the push that delivered its
    access unit's last byte: 512-byte pushes of p_mv (1,089 bytes, the
    IDR's access unit with the parameter sets first)."""
    from libde265_tpu_torch import api
    from benchmark import generator
    cell = small_cell(mix="transcode", push_kib=[0.5])
    (req,) = generator.requests(cell.data, cell.mix)
    times = []
    orig = api.push_data

    def push(dec, data, pts=None):
        times.append(time.perf_counter())
        return orig(dec, data, pts)

    api.push_data = push
    try:
        run, checks, *_ = bench_run.run_cell(ROOT, cell, 5, 1e-3, 0, "cpu")
    finally:
        api.push_data = orig
    assert len(run.requests) == 1 and checks["planes_wrong"] == 0
    times = times[-3:]                 # the window's request: 3 pushes
    want = [min(e - 1, len(cell.data) - 1) // 512 for e in req.au_ends]
    for pic, k in zip(run.requests[0].returned, want):
        assert pic.t_due <= times[k]
        assert k == 0 or pic.t_due > times[k - 1]
    assert len(run.requests[0].returned) == 4


def test_traced_spans_on_cpu():
    cell = small_cell(mix="transcode")
    run, checks, *_ = bench_run.run_cell(ROOT, cell, 9, 1.0, 1, "cpu")
    assert checks["planes_wrong"] == 0
    r = run.requests[0]
    assert set(r.spans) >= {"drive", "parse", "reconstruct"}
    assert r.spans["drive"] >= r.spans["parse"] + r.spans["reconstruct"]
    assert r.pack_s > 0
    for name in ("drive_ms_per_frame", "parse_ms_per_frame",
                 "pack_ms_per_frame"):
        assert spec.reader(ROOT, name).read(run) > 0
    # the wrappers are gone after the run
    from libde265_tpu_torch import api, native_frontend
    assert api._decode_plans.__name__ == "_decode_plans"
    assert native_frontend.NativeFrontend.parse.__name__ == "parse"


def _bench(args, cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    r = _bench(["--workload", "gop1080p.keyframes", "--seed", "1",
                "--seconds", "1"], ROOT)
    assert r.returncode == 3 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _bench(["--workload", "ld4k_light.transcode", "--seed", "1",
                "--seconds", "1"], tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    r = _bench(["--workload", "no_such.cell", "--seed", "1", "--seconds",
                "1"], ROOT)
    assert r.returncode == 2 and r.stdout == ""
