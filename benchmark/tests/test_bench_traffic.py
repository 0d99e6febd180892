"""The generator: every mix is deterministic for a seed, and every seed
draws the same set of requests and push sizes."""
import itertools
import os
from collections import Counter

import pytest

from benchmark import generator, spec
from benchmark.stream import nal_units
from bench_cells import DATA, ROOT

BIG = 2 ** 31 + 12345          # seeds run past 32 signed bits
HUGE = 2 ** 62 + 7


def _data(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _take(reqs, mix, seed, n):
    return [(r.key, tuple(s)) for r, s in
            itertools.islice(generator.schedule(reqs, mix, seed), n)]


@pytest.mark.parametrize("mix,stream", [("transcode", "ld4k_light"),
                                        ("keyframes", "gop1080p")])
@pytest.mark.parametrize("seed", [0, BIG, HUGE])
def test_mix_deterministic_for_a_seed(mix, stream, seed):
    m = spec.traffic(ROOT, mix)
    reqs = generator.requests(_data(stream), m)
    a = _take(reqs, m, seed, 40)
    assert a == _take(reqs, m, seed, 40)
    assert a != _take(reqs, m, seed + 1, 40)
    w = generator.warmup(reqs, m, seed)
    assert [(r.key, s) for r, s in w] == \
        [(r.key, s) for r, s in generator.warmup(reqs, m, seed)]


def test_transcode_pushes():
    m = spec.traffic(ROOT, "transcode")
    data = _data("ld4k_light")
    (req,) = generator.requests(data, m)
    assert req.data == data and req.pictures == tuple(range(33))
    assert req.au_ends[-1] == len(data)
    sizes = [s for _, s in itertools.islice(
        generator.schedule([req], m, BIG), 20)]
    for s in sizes:
        assert sum(s) == len(data)
        assert all(x <= 256 * 1024 for x in s)
        assert all(x in [k * 1024 for k in m["push_kib"]] for x in s[:-1])
    # each file draws its own order of the same sizes
    assert len({tuple(s) for s in sizes}) > 1


def test_keyframe_requests():
    m = spec.traffic(ROOT, "keyframes")
    data = _data("gop1080p")
    reqs = generator.requests(data, m)
    assert [r.pictures for r in reqs] == [(i,) for i in range(0, 96, 6)]
    for r in reqs:
        assert [n.type for n in nal_units(r.data)] == [19]
        assert r.au_ends == (len(r.data),)
    assert [n.type for n in nal_units(generator.prefix(data, m))] == \
        [32, 33, 34]
    order = _take(reqs, m, BIG, 64)
    rounds = [[k for k, _ in order[i:i + 16]] for i in range(0, 64, 16)]
    assert all(sorted(r) == list(range(16)) for r in rounds)
    assert len({tuple(r) for r in rounds}) == 4     # a new order each round
    assert all(s == (len(reqs[k].data),) for k, s in order)
    assert [r.key for r, _ in generator.warmup(reqs, m, 1)] == \
        list(range(16))


def test_seeds_draw_the_same_set():
    m = spec.traffic(ROOT, "keyframes")
    reqs = generator.requests(_data("gop1080p"), m)
    a = Counter(k for k, _ in _take(reqs, m, 11, 160))
    b = Counter(k for k, _ in _take(reqs, m, BIG, 160))
    assert a == b == Counter({k: 10 for k in range(16)})


def test_bad_mix_refused():
    m = dict(spec.traffic(ROOT, "transcode"), clients=4)
    with pytest.raises(ValueError):
        generator.requests(_data("p_mv"), m)
