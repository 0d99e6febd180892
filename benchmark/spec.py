"""What a cell is made of, found by the names in BENCHMARK.json: its
configuration file, its traffic mix (benchmark/traffic/<mix>.json), its
stream (pinned by SHA-256), the golden digests beside the configuration,
the readers of its metrics (benchmark/metrics/<metric>.py), the
kernels' byte and operation counts (benchmark/roofline/*.py) and the
table of peaks (benchmark/peaks.json)."""
import glob
import importlib.util
import json
import os
from dataclasses import dataclass

from .stream import sha256

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(Exception):
    """The benchmark's files do not make up the cell asked for."""


def _json(path):
    with open(path) as f:
        return json.load(f)


def _inside(root, rel):
    path = os.path.normpath(os.path.join(root, rel))
    if os.path.isabs(rel) or not path.startswith(os.path.abspath(root)
                                                 + os.sep):
        raise SpecError(f"{rel}: not a path inside the checkout")
    return path


def load_benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench, name):
    """(workload entry, configuration entry) of the cell `name`."""
    for w in bench["workloads"]:
        if w["name"] == name:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise SpecError(f"{name}: no configuration {w['config']!r}")
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    data: bytes         # the stream
    golden: list        # per picture, dec265's [Y, Cb, Cr] MD5s


def load_cell(root, name, bench=None):
    """The cell `name` of BENCHMARK.json with its files read and its
    stream checked."""
    bench = load_benchmark(root) if bench is None else bench
    work, entry = cell(bench, name)
    cfg = config(root, entry)
    return Cell(name, work["chips"], cfg, traffic(root, work["traffic"]),
                stream(root, cfg), golden(root, cfg))


def config(root, entry):
    return _json(_inside(root, entry["file"]))


def traffic(root, name):
    return _json(os.path.join(root, "benchmark", "traffic", name + ".json"))


def stream(root, cfg):
    """The configuration's stream, checked against its SHA-256."""
    st = cfg["stream"]
    with open(_inside(root, st["path"]), "rb") as f:
        data = f.read()
    got = sha256(data)
    if got != st["sha256"] or len(data) != st["bytes"]:
        raise SpecError(f"{st['path']}: SHA-256 {got} ({len(data)} bytes), "
                        f"the configuration pins {st['sha256']} "
                        f"({st['bytes']} bytes)")
    return data


def golden(root, cfg):
    """Per picture, in output order, dec265's [Y, Cb, Cr] MD5s."""
    return _json(_inside(root, cfg["golden"]["file"]))["md5"]


def metrics(bench, cell_name, trace):
    """The metric entries a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a "workloads"
    list only in the cells it names."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, metric_name):
    """The module benchmark/metrics/<metric_name>.py (its read(run))."""
    path = os.path.join(root, "benchmark", "metrics", metric_name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no reader {path}")
    return _module(path, "benchmark_metric_" + metric_name.replace(".", "_"))


def rooflines(root):
    """Every kernel's count module, benchmark/roofline/*.py, by name."""
    return [_module(p, "benchmark_roofline_"
                    + os.path.basename(p)[:-3].replace(".", "_"))
            for p in sorted(glob.glob(os.path.join(root, "benchmark",
                                                   "roofline", "*.py")))]


def peaks(root):
    return _json(os.path.join(root, "benchmark", "peaks.json"))
