"""The one general generator of the benchmark's traffic: what a mix's
data file (benchmark/traffic/<mix>.json) says, turned into requests
over a configuration's stream. Same seed, same requests: the seed only
orders the requests and the push sizes; every seed draws the same set
of them.

A mix's keys:
  request     "stream": one request is the whole stream;
              "irap_access_unit": one request is one IRAP access unit
  order       "sequential": the requests in stream order, repeated;
              "permutation": a seeded permutation, a new one each round
  decoder     "per_request": new_decoder() for each request, dropped
              after it; "shared_reset": one decoder, reset() before
              each request
  param_sets  "in_request": pushed as they stand in the stream;
              "once": pushed at set-up, left out of every request
  push_kib    a list of push sizes in KiB, permuted for each request
              from the seed and used in turn until the request's bytes
              are pushed; null: the whole request in one push
  warmup      "first_request": the first request of the schedule, once;
              "every_request": every distinct request, once
  trace_requests  {"first", "count"}: which requests of the window the
              traced run profiles
  loop, clients  "closed" and 1: the only ones this generator drives
"""
import random
from dataclasses import dataclass

from .stream import PARAM_SET_TYPES, access_units

KIB = 1024


@dataclass(frozen=True)
class Request:
    key: int            # which distinct request (its place in requests())
    data: bytes         # the bytes pushed
    au_ends: tuple      # per picture: the offset one past its AU's last byte
    pictures: tuple     # per picture: its decode-order index in the stream


def _check_mix(mix):
    want = {"loop": ("closed",), "clients": (1,),
            "request": ("stream", "irap_access_unit"),
            "order": ("sequential", "permutation"),
            "decoder": ("per_request", "shared_reset"),
            "param_sets": ("in_request", "once"),
            "warmup": ("first_request", "every_request")}
    for k, ok in want.items():
        if mix.get(k) not in ok:
            raise ValueError(f"traffic: {k}={mix.get(k)!r}, want one of "
                             f"{ok}")
    sizes = mix.get("push_kib")
    if sizes is not None and (not sizes or min(sizes) <= 0):
        raise ValueError("traffic: push_kib must be null or positive sizes")


def prefix(data, mix):
    """The bytes pushed once at set-up: the stream's parameter sets where
    the mix pushes them once, else nothing."""
    if mix["param_sets"] != "once":
        return b""
    return b"".join(data[n.begin:n.end] for au in access_units(data)
                    for n in au.nals if n.type in PARAM_SET_TYPES)


def requests(data, mix):
    """The distinct requests of a mix over a stream, in stream order."""
    _check_mix(mix)
    aus = access_units(data)
    if mix["request"] == "stream":
        groups = [aus]
    else:
        groups = [[au] for au in aus if au.irap]
    out = []
    for key, group in enumerate(groups):
        parts, ends, pics, off = [], [], [], 0
        for au in group:
            nals = [n for n in au.nals if not (
                mix["param_sets"] == "once" and n.type in PARAM_SET_TYPES)]
            for n in nals:
                parts.append(data[n.begin:n.end])
                off += n.end - n.begin
            if au.picture is not None:
                ends.append(off)
                pics.append(au.picture)
        out.append(Request(key, b"".join(parts), tuple(ends), tuple(pics)))
    return out


def schedule(reqs, mix, seed):
    """Endless iterator of (request, push sizes in bytes) for the window,
    drawn from `seed`."""
    rng = random.Random(seed)
    while True:
        order = list(range(len(reqs)))
        if mix["order"] == "permutation":
            rng.shuffle(order)
        for k in order:
            yield reqs[k], push_sizes(len(reqs[k].data), mix, rng)


def push_sizes(n, mix, rng):
    """Sizes of the pushes of an n-byte request: the mix's push sizes in
    a seeded order, in turn, the last one cut to what is left."""
    kib = mix.get("push_kib")
    if kib is None:
        return [n]
    order = list(kib)
    rng.shuffle(order)
    out, left = [], n
    while left > 0:
        out.append(min(int(order[len(out) % len(order)] * KIB), left))
        left -= out[-1]
    return out


def warmup(reqs, mix, seed):
    """(request, push sizes) pairs that set-up runs untimed."""
    rng = random.Random(seed ^ 0x5EED)
    chosen = reqs[:1] if mix["warmup"] == "first_request" else reqs
    return [(r, push_sizes(len(r.data), mix, rng)) for r in chosen]
