"""The union, the idle share, the kernel counts and the roofline share
on a small synthetic Chrome trace."""
import pytest

from benchmark import spec
from benchmark.client import Picture, RequestRecord
from benchmark.record import RunRecord
from benchmark.trace import merged, summarize
from bench_cells import ROOT

G4K = {"width": 3840, "height": 2160, "bit_depth": 8, "chroma_format_idc": 1}


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _events():
    """A 1,000 us window; device busy 100-300 (two overlapping kernels),
    400-450 (memcpy), 900-1,100 (a kernel half outside the window).
    Host: drive 0-1,000 holding parse 0-380 and reconstruct 380-1,000,
    which holds pack 460-700."""
    return [
        _x("bench.window", 0, 1000, "user_annotation"),
        _x("bench.drive", 0, 1000, "user_annotation"),
        _x("bench.parse", 0, 380, "user_annotation"),
        _x("bench.reconstruct", 380, 620, "user_annotation"),
        _x("bench.pack", 460, 240, "user_annotation"),
        _x("void tile_table_kernel<unsigned char>(...)", 100, 150, "kernel"),
        _x("sao_ctb_kernel(Args)", 200, 100, "kernel"),
        _x("Memcpy DtoH (Device -> Pinned)", 400, 50, "gpu_memcpy"),
        _x("intra_wave_kernel(...)", 900, 200, "kernel"),
        _x("aten::add", 10, 5, "cpu_op"),
    ]


def test_union():
    assert merged([(5, 6), (0, 2), (1, 3), (2, 2.5)]) == [[0, 3], [5, 6]]
    assert merged([]) == []


def test_busy_idle_and_kernels():
    s = summarize(_events())
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.n_kernels == 3
    # the kernel half outside the window counts for its half inside
    assert s.kernels["intra_wave_kernel(...)"] == [1, pytest.approx(1e-4)]
    assert s.device_ops["Memcpy DtoH (Device -> Pinned)"] == \
        pytest.approx(5e-5)
    # idle: 0-100 and 300-380 in parse, 380-400 and 450-460 and 700-900
    # in reconstruct, 460-700 in pack
    assert s.idle_by_span == pytest.approx(
        {"parse": 180e-6, "reconstruct": 230e-6, "pack": 240e-6})
    assert sum(s.idle_by_span.values()) == pytest.approx(650e-6)


def _run(trace, pictures=2, geometry=G4K):
    rec = RequestRecord(0, tuple(range(pictures)), profiled=True)
    rec.returned = [Picture(0.0, 1.0, []) for _ in range(pictures)]
    return RunRecord(config={"geometry": geometry}, mix={}, seed=1,
                     setup_s=1.0, requests=[rec], trace=trace,
                     rooflines=spec.rooflines(ROOT), peaks=spec.peaks(ROOT))


def _read(name, run):
    return spec.reader(ROOT, name).read(run)


def test_idle_share_and_launches():
    run = _run(summarize(_events()))
    assert _read("device_idle_pct", run) == pytest.approx(65.0)
    assert _read("launches_per_frame", run) == pytest.approx(1.5)


def test_roofline_share():
    # two K3 launches, each as long as twice its bound, one unknown kernel
    k3 = [m for m in spec.rooflines(ROOT) if m.KERNEL == "sao_ctb_kernel"][0]
    hbm, ops = spec.peaks(ROOT)["hbm_bytes_per_s"], \
        spec.peaks(ROOT)["int32_ops_per_s"]
    b = [max(x / hbm, o / ops) for x, o in k3.launches(G4K)]
    ev = [_x("bench.window", 0, 10000, "user_annotation"),
          _x("sao_ctb_kernel(Args)", 0, 2e6 * b[0], "kernel"),
          _x("sao_ctb_kernel(Args)", 5000, 2e6 * b[1], "kernel"),
          _x("some_other_kernel", 8000, 100, "kernel")]
    run = _run(summarize(ev))
    # two launches count as 2/3 of K3's three-launch group
    want = 100 * (2 / 3) * sum(b) / (2 * (b[0] + b[1]))
    assert _read("kernels_roofline", run) == pytest.approx(want)
    assert _read("kernels_roofline", _run(summarize(ev[:1] + ev[3:]))) \
        is None


def test_rooflines_match_the_card_runs_bounds():
    """The counts from shapes give chip_smoke.py's bounds for the 4K
    luma and chroma launches of K1 and K2 (PERF.md's kernel table:
    0.0458 / 0.0077 ms and 0.0546 / 0.0150 ms)."""
    hbm = spec.peaks(ROOT)["hbm_bytes_per_s"]
    mods = {m.KERNEL: m for m in spec.rooflines(ROOT)}
    ms = {k: [round(b / hbm * 1e3, 4) for b, _ in m.launches(G4K)]
          for k, m in mods.items()}
    assert ms["tile_table_kernel"] == [0.0458, 0.0077]
    assert ms["mc_predict_kernel"] == [0.0546, 0.0150]
    assert len(ms["sao_ctb_kernel"]) == 3
    assert len(ms["intra_wave_kernel"]) == 2
