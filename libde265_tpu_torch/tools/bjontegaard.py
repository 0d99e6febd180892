"""Bjontegaard-delta metrics between two RD curves (counterpart of the
JAX package's tools/bjontegaard.py and of libde265's bjoentegaard).

    python -m libde265_tpu_torch.tools.bjontegaard curve1.json curve2.json

Each JSON file is a list of {"kbps": .., "psnr_y": ..} points (what
rd_curves writes). Host numpy only.
"""
import json
import sys

import numpy as np


def bd_psnr(c1, c2):
    """BD-PSNR: average PSNR difference over the overlapping rate range."""
    r1 = np.log10([p["kbps"] for p in c1])
    p1 = [p["psnr_y"] for p in c1]
    r2 = np.log10([p["kbps"] for p in c2])
    p2 = [p["psnr_y"] for p in c2]
    f1 = np.polyfit(r1, p1, min(3, len(r1) - 1))
    f2 = np.polyfit(r2, p2, min(3, len(r2) - 1))
    lo = max(min(r1), min(r2))
    hi = min(max(r1), max(r2))
    x = np.linspace(lo, hi, 100)
    return float(np.mean(np.polyval(f2, x) - np.polyval(f1, x)))


def bd_rate(c1, c2):
    """BD-rate: average bitrate difference (%) at equal quality; nan
    where the curves do not overlap in quality."""
    p1 = [p["psnr_y"] for p in c1]
    r1 = np.log10([p["kbps"] for p in c1])
    p2 = [p["psnr_y"] for p in c2]
    r2 = np.log10([p["kbps"] for p in c2])
    f1 = np.polyfit(p1, r1, min(3, len(p1) - 1))
    f2 = np.polyfit(p2, r2, min(3, len(p2) - 1))
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    if hi <= lo:
        return float("nan")
    x = np.linspace(lo, hi, 100)
    diff = np.polyval(f2, x) - np.polyval(f1, x)
    return float((10 ** np.mean(diff) - 1) * 100)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: bjontegaard curve1.json curve2.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        c1 = json.load(f)
    with open(argv[1]) as f:
        c2 = json.load(f)
    print(f"BD-PSNR: {bd_psnr(c1, c2):+.3f} dB")
    print(f"BD-rate: {bd_rate(c1, c2):+.2f} %")
    return 0


if __name__ == "__main__":
    sys.exit(main())
