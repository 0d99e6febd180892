"""Small cells for the benchmark's CPU tests: a stream of tests/data with
the dec265 MD5s of its manifest, driven on device="cpu" (the kernels'
plain PyTorch versions): the logic of the harness, not its numbers."""
import json
import os

from benchmark import spec

ROOT = spec.ROOT
DATA = os.path.join(ROOT, "tests", "data")
GEOMETRY = {"width": 64, "height": 64, "bit_depth": 8,
            "chroma_format_idc": 1}


def small_cell(stream="p_mv", manifest="manifest_inter.json",
               mix="transcode", **mix_changes):
    with open(os.path.join(DATA, manifest)) as f:
        md5 = json.load(f)[stream]["md5"]
    with open(os.path.join(DATA, stream + ".bin"), "rb") as f:
        data = f.read()
    m = dict(spec.traffic(ROOT, mix))
    if m["push_kib"] is not None:
        m["push_kib"] = [1, 2]          # several pushes per small file
    m["trace_requests"] = {"first": 0, "count": 0}  # no profiler on the CPU
    m.update(mix_changes)
    cfg = {"name": stream, "geometry": GEOMETRY,
           "structure": {"output_order": "decode_order"}}
    return spec.Cell(stream, 1, cfg, m, data,
                     [[f["y"], f["u"], f["v"]] for f in md5])
