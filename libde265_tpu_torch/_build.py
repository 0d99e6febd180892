"""Build and load the port's native pieces at first use.

CUDA kernels: every csrc/*.cu file compiles with nvcc for sm_90a (one
nvcc process per source, all started together), and the objects link into
ONE shared library with a plain C interface, loaded with ctypes. The
library is named by a hash of the sources and flags, so an edited kernel
rebuilds and an unchanged one loads from build/. No PyTorch headers are included,
which keeps a cold build to seconds (torch.utils.cpp_extension.load
takes minutes for the same kernels).

Front end: native/libhevc_frontend.so (gitignored) is built by
ensure_frontend when a fresh checkout lacks it (the repo's root
conftest.py calls it once before the tests start).
"""
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PKG)
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NATIVE = os.path.join(REPO, "native")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the last nvcc build (None: cached)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def kernels_lib():
    """ctypes handle of the compiled kernel library (builds on first
    use)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(os.path.basename(s).encode())
            with open(s, "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD, f"libde265_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            t0 = time.time()
            _compile_and_link(
                [s for s in srcs if s.endswith(".cu")], so)
            build_seconds = time.time() - t0
        _lib = ctypes.CDLL(so)
        return _lib


def _compile_and_link(cus, so):
    """One nvcc per source, run in parallel, then one link into `so`."""
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, cu],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cu, o in zip(cus, objs)]
    try:
        outs = [p.communicate() for p in procs]      # waits for all
        for cu, p, (out, err) in zip(cus, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu} ({p.returncode}):"
                                   f"\n{out}\n{err}")
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def kernel_fn(name, argtypes):
    """The C entry `name` of the kernel library with its argtypes set;
    every entry returns a cudaError_t (0 = launched)."""
    fn = getattr(kernels_lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def ensure_frontend(native=NATIVE):
    """Path of `native`/libhevc_frontend.so, built first when it is
    missing. The build runs `make` on copies of native/Makefile and
    frontend.cc in a temporary directory under build/, under a lock
    shared by every process of this checkout, and the result is renamed
    into place: no process ever sees a partly written library. A failed
    `make` raises."""
    so = os.path.join(native, "libhevc_frontend.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "frontend.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            for f in ("Makefile", "frontend.cc"):
                shutil.copy(os.path.join(native, f), tmp)
            r = subprocess.run(["make", "-C", tmp], capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(f"make of {native}/frontend.cc failed "
                                   f"({r.returncode}):\n{r.stdout}\n"
                                   f"{r.stderr}")
            # a copy beside the target, then one rename: atomic even
            # where build/ and `native` lie on different file systems
            part = f"{so}.{os.getpid()}.part"
            shutil.copy(os.path.join(tmp, "libhevc_frontend.so"), part)
            os.replace(part, so)
    return so
