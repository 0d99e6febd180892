"""_build.ensure_frontend: a checkout without native/libhevc_frontend.so
builds it at first use. Run against a copy of native/ (Makefile and
frontend.cc) in a temporary directory, so the library the other tests
load is never touched."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a process that points the port at the copy, parses a stream with the
# library absent (native_frontend._lib builds it) and loads it again
_CHILD = """
import ctypes, sys
from libde265_tpu_torch import _build
_build.NATIVE = sys.argv[1]
from libde265_tpu_torch.api import _parse
plans = _parse(open('tests/data/p_mv.bin', 'rb').read())
ctypes.CDLL(_build.ensure_frontend(sys.argv[1])).fe_new
print(len(plans))
"""


def _copy_native(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for f in ("Makefile", "frontend.cc"):
        shutil.copy(os.path.join(REPO, "native", f), d)
    return str(d)


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two processes start together on a copy of native/ without the
    library: one builds (make in a temporary directory, then a rename),
    the other waits on the lock; both parse p_mv through `_parse` and
    load a complete library. Nothing else is left in the copy."""
    native = _copy_native(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "HEVC_FRONTEND_SO")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, native],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "4"
    assert sorted(os.listdir(native)) == ["Makefile", "frontend.cc",
                                          "libhevc_frontend.so"]


def test_failed_make_raises_and_leaves_no_library(tmp_path):
    """A frontend.cc that does not compile: ensure_frontend raises with
    make's output, and no library (whole or partial) appears."""
    from libde265_tpu_torch import _build
    native = _copy_native(tmp_path)
    with open(os.path.join(native, "frontend.cc"), "w") as f:
        f.write("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.ensure_frontend(native)
    assert sorted(os.listdir(native)) == ["Makefile", "frontend.cc"]


def test_present_library_is_returned_without_a_build(tmp_path):
    """An existing library is returned at once (no make runs: the copy
    has no sources to build from)."""
    from libde265_tpu_torch import _build
    d = tmp_path / "native"
    d.mkdir()
    (d / "libhevc_frontend.so").write_bytes(b"")
    assert _build.ensure_frontend(str(d)) == str(d / "libhevc_frontend.so")
