"""What decides `correct`: every plane of every picture returned in the
window against dec265's digests (benchmark/configs/<config>.golden.json),
and the modules the run has loaded.

Each number compared has the limit 0: the comparison is exact.
  planes_wrong       planes whose MD5 differs from dec265's for the
                     picture at that place of the request's output
  pictures_missing   pictures a request should have returned and did not
  pictures_extra     pictures a request returned beyond those
  requests_failed    requests the program raised on
"""
import sys

from .stream import plane_md5

LIMITS = {"planes_wrong": 0, "pictures_missing": 0, "pictures_extra": 0,
          "requests_failed": 0}
FORBIDDEN = ("jax", "jaxlib", "flax", "libde265_tpu")


def compare(requests, golden):
    """(checks {name: value}, attempted pictures, failed pictures)."""
    checks = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for rec in requests:
        want = [golden[i] for i in rec.pictures]
        got = rec.returned
        attempted += len(want)
        checks["requests_failed"] += rec.error is not None
        checks["pictures_missing"] += max(0, len(want) - len(got))
        checks["pictures_extra"] += max(0, len(got) - len(want))
        failed += max(0, len(want) - len(got))
        for pic, md5s in zip(got, want):
            wrong = sum(len(pic.planes) <= i or plane_md5(pic.planes[i])
                        != m for i, m in enumerate(md5s))
            wrong += max(0, len(pic.planes) - len(md5s))
            checks["planes_wrong"] += wrong
            failed += wrong > 0
    return checks, attempted, failed


def correct(checks, attempted):
    """Every number within its limit, and something was attempted."""
    return attempted > 0 and all(checks[k] <= LIMITS[k] for k in LIMITS)


def forbidden_modules(modules=None):
    """Top-level names of loaded modules (the part before the first dot,
    compared whole) that the port may not load."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
