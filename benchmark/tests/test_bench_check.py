"""What decides `correct`: the picture comparison and the check for
modules the port may not load."""
import os
import subprocess
import sys

import numpy as np

from benchmark import check
from benchmark.client import Picture, RequestRecord
from benchmark.stream import plane_md5
from bench_cells import ROOT


def _planes(v):
    return [np.full((4, 4), v, np.uint8), np.full((2, 2), v, np.uint8),
            np.full((2, 2), v + 1, np.uint8)]


GOLDEN = [[plane_md5(p) for p in _planes(v)] for v in range(6)]


def _rec(i, pictures, values, error=None):
    r = RequestRecord(i, tuple(pictures), error=error)
    r.returned = [Picture(0.0, 0.0, _planes(v)) for v in values]
    return r


def test_compare_exact():
    checks, att, failed = check.compare(
        [_rec(0, [0, 1, 2], [0, 1, 2]), _rec(1, [3], [3])], GOLDEN)
    assert checks == dict.fromkeys(check.LIMITS, 0)
    assert (att, failed) == (4, 0) and check.correct(checks, att)


def test_compare_faults():
    bad = _planes(1)
    bad[2][1, 1] ^= 1                       # one sample of Cr altered
    r = _rec(0, [0, 1, 2], [0, 1, 2])
    r.returned[1].planes = bad
    checks, att, failed = check.compare(
        [r, _rec(1, [3, 4], [3]), _rec(2, [5], [5, 5]),
         _rec(3, [0], [], error="Traceback ...")], GOLDEN)
    assert checks == {"planes_wrong": 1, "pictures_missing": 2,
                      "pictures_extra": 1, "requests_failed": 1}
    assert (att, failed) == (7, 3) and not check.correct(checks, att)
    assert not check.correct(dict.fromkeys(check.LIMITS, 0), 0)


def test_forbidden_top_level_names():
    assert check.forbidden_modules({"libde265_tpu_torch": 1,
                                    "libde265_tpu_torch.api": 1,
                                    "jaxtyping": 1, "numpy": 1}) == []
    assert check.forbidden_modules({"jax.numpy": 1, "libde265_tpu.ops": 1,
                                    "flax": 1}) == \
        ["flax", "jax", "libde265_tpu"]


def test_port_and_harness_load_no_jax():
    """In a fresh process: the harness and the port's push API (the
    modules a run loads) bring in neither JAX nor the JAX package."""
    code = ("import benchmark.run, benchmark.spans, benchmark.trace\n"
            "from libde265_tpu_torch import api, native_frontend\n"
            "from benchmark import check\n"
            "print(check.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
