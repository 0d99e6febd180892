"""On the card: one short run of each cell through BENCHMARK.json's
command, that must come out correct, and the control, that must not.
Marked `cuda`; skipped where there is no card (decided inside the
test). On the card:

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""
import json
import os
import subprocess
import sys

import pytest

from bench_cells import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _bench(*args):
    r = subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1200, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["ld4k_light.transcode",
                                  "gop1080p.keyframes"])
def test_cell_correct_and_control_not(card, cell):
    out = _bench("--workload", cell, "--seed", "2147483659", "--seconds",
                 "5", "--trace", "0")
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"decode_fps", "picture_latency_p95_ms",
                                   "host_cpu_ms_per_frame", "setup_s"}
    assert list(out)[-1] == "checks"
    ctl = _bench("--workload", cell, "--seed", "2147483660", "--seconds",
                 "3", "--control", "deblock_off")
    assert not ctl["correct"] and ctl["checks"]["planes_wrong"]["value"] > 0
