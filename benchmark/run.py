"""One run of one cell of the benchmark of libde265_tpu_torch:

    python3 -m benchmark.run --workload CELL --seed N --seconds S \
        --trace 0|1

from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. The cell (BENCHMARK.json) names a configuration
(benchmark/configs/<config>.json: a stream pinned by SHA-256 and dec265's
digests beside it) and a traffic mix (benchmark/traffic/<mix>.json).
Set-up imports the port, initialises CUDA and runs the mix's warm-up
requests untimed; the window then drives the push API for S seconds
(the request under way when they run out is finished and counted, and
the window is as long as that); every plane of every picture returned
is then compared with dec265's MD5. With --trace 0 the result holds the
cell's end-to-end metrics, with --trace 1 its per-layer ones, read
around the API calls and from a torch.profiler trace of a bounded
stretch of the window.

Standard output: information lines starting with "#", then one JSON
line: correct, attempted, failed, metrics, device, breakdown (traced),
checks (each number compared and its limit, last). Standard error ends
with the same numbers, one a line. Exit code 0 when a result was
printed; 2 for a bad cell or a stream that fails its SHA-256; 3 when
CUDA or the cell's cards are missing; 4 when the process has loaded
jax, jaxlib, flax or libde265_tpu.

--control deblock_off runs the program with its own kill-switch
DE265_DISABLE_DEBLOCK=1 (dec265 --disable-deblocking), the control that
has to come out not correct; measurement runs never pass it.
"""
import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time

from . import check, generator, spec
from .client import Client, RequestRecord
from .record import RunRecord

CONTROLS = {"deblock_off": {"DE265_DISABLE_DEBLOCK": "1"}}
# build and kernel caches the program or torch may write, at fixed paths
# inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "CUDA_CACHE_PATH": "nv_compute"}


def process_age():
    """Seconds since this process started (Linux /proc; 0.0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def cpu_seconds():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def set_cache_dirs(root):
    base = os.path.join(root, ".benchmark_cache")
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def run_cell(root, cell, seed, seconds, trace, device, t_start=None,
             age=0.0):
    """Set-up, window and check of a spec.Cell on `device`. `age` is the
    process's age at `t_start`: setup_s runs from the start of the
    process to the first timed push. Returns (RunRecord, checks,
    attempted, failed, [information lines])."""
    t_start = time.perf_counter() if t_start is None else t_start
    if cell.config["structure"]["output_order"] != "decode_order":
        raise spec.SpecError("the client maps pictures to access units in "
                             "decode order only")
    from libde265_tpu_torch import api
    probe = None
    if trace:
        from .spans import Probe
        probe = Probe()
        probe.install()
    try:
        return _run(root, cell, seed, seconds, trace, device, t_start, age,
                    api, probe)
    finally:
        if probe is not None:
            probe.uninstall()


def _run(root, cell, seed, seconds, trace, device, t_start, age, api,
         probe):
    mix = cell.mix
    reqs = generator.requests(cell.data, mix)
    client = Client(api, device, mix, cell.data, probe)
    client.open()
    for req, sizes in generator.warmup(reqs, mix, seed):
        client.run(req, sizes, RequestRecord(-1, req.pictures))
    if client.errors:
        raise RuntimeError("a warm-up request failed:\n" + client.errors[0])
    _sync(device)
    run = RunRecord(config=cell.config, mix=mix, seed=seed, setup_s=0.0)
    if trace:
        run.rooflines = spec.rooflines(root)
        run.peaks = spec.peaks(root)
    tr = mix.get("trace_requests", {"first": 0, "count": 0})
    first, last = tr["first"], tr["first"] + tr["count"]
    capture = captured = None
    sched = generator.schedule(reqs, mix, seed)
    t0 = time.perf_counter()
    run.setup_s = age + t0 - t_start
    c0 = cpu_seconds()
    i = 0
    while time.perf_counter() - t0 < seconds or capture is not None:
        req, sizes = next(sched)
        rec = RequestRecord(i, req.pictures)
        if trace and i == first and last > first:
            from .trace import Capture
            capture = Capture()
            capture.start()
        rec.profiled = capture is not None
        client.run(req, sizes, rec)
        run.requests.append(rec)
        i += 1
        if capture is not None and i == last:
            capture.stop()
            captured, capture = capture, None
    run.window_s = time.perf_counter() - t0
    run.cpu_s = cpu_seconds() - c0
    client.close()
    run.stats = client.stats
    info = [f"# requests {len(run.requests)}, pictures "
            f"{len(run.pictures)}, window {run.window_s:.6f} s, CPU "
            f"{run.cpu_s:.3f} s",
            "# request ms " + " ".join(
                f"{(r.t_end - r.t_start) * 1e3:.1f}" for r in run.requests),
            "# routes " + " ".join(f"{k}={v}" for k, v in
                                   sorted(run.stats.items()))]
    if client.errors:
        info.append("# first request error:\n" + client.errors[0])
    del client
    gc.collect()
    if captured is not None:
        from .trace import summarize
        run.trace = summarize(captured.events())
    checks, attempted, failed = check.compare(run.requests, cell.golden)
    return run, checks, attempted, failed, info


def _sync(device):
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def nvidia_smi():
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({e})"


def breakdown(summary):
    ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[f"idle while host in {n}", s] for n, s in idle]}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    a = ap.parse_args(argv)
    t_main, age = time.perf_counter(), process_age()
    root = os.getcwd()
    set_cache_dirs(root)
    if a.control:
        os.environ.update(CONTROLS[a.control])
    try:
        bench = spec.load_benchmark(root)
        cell = spec.load_cell(root, a.workload, bench)
    except (OSError, ValueError, KeyError, spec.SpecError) as e:
        print(f"benchmark: {e!r}", file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: {a.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    smi0 = nvidia_smi()
    run, checks, attempted, failed, info = run_cell(
        root, cell, a.seed, a.seconds, a.trace, "cuda", t_main, age)
    mem = torch.cuda.max_memory_allocated()
    smi1 = nvidia_smi()
    bad = check.forbidden_modules()
    if bad:
        print(f"benchmark: the process has loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    metrics = {}
    for m in spec.metrics(bench, a.workload, a.trace):
        v = spec.reader(root, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": mem}
    out = {"correct": check.correct(checks, attempted),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if a.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in checks.items()}
    for line in info:
        print(line)
    print(f"# workload {a.workload} seed {a.seed} seconds {a.seconds} "
          f"trace {a.trace} control {a.control}; host CPUs "
          f"{len(os.sched_getaffinity(0))}, torch threads "
          f"{torch.get_num_threads()}")
    print(f"# nvidia-smi before the window: {smi0}")
    print(f"# nvidia-smi after the window: {smi1}")
    print(f"# memory_peak_bytes {mem} of "
          f"{torch.cuda.get_device_properties(0).total_memory}")
    if run.trace is not None:
        print(f"# trace: {run.trace.n_kernels} kernels, busy "
              f"{run.trace.busy_s} s of {run.trace.window_s} s")
    print(json.dumps(out), flush=True)
    for k, v in checks.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
