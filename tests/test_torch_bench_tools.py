"""The port's measurement tools (libde265_tpu_torch/tools/bench*.py,
profile_*.py) and the frame program's `stages` against the JAX package
on the CPU: decode_frame_device(stages=...) against the JAX program's
ablation, exact; tools.bench's protocol on p_mv (every blob it uploads,
those the spawned workers ship through shared memory among them, equal
to the JAX pack_blob's bytes; the workers free of CUDA and jax; no
segment left under /dev/shm); bench_frontend's counts against the JAX
tool's; bench_intra_scan's two intra paths; and each other tool run
once at a small size. The JAX band scan runs in interpret mode
(DE265_INTRA_SCAN=force), as the JAX package's own CPU tests run it."""
import contextlib
import dataclasses
import importlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA = os.path.join(TESTS, "data")

from libde265_tpu_torch.tools.bench import static_slot_map  # noqa
from libde265_tpu_torch.tools.profile_frame_stages import VARIANTS  # noqa


def port_tool(name, argv):
    """(exit code, stdout) of libde265_tpu_torch.tools.<name>.main."""
    mod = importlib.import_module(f"libde265_tpu_torch.tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue()


def _plans(name):
    from libde265_tpu_torch.api import _parse
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return _parse(f.read())


def _seeded_state(cj, cp, seed):
    """The same random DPB stacks in both packages' layouts, and the JAX
    tile tables built from them (numpy)."""
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import packing as P
    rng = np.random.RandomState(seed)
    H, W, S = cp.H, cp.W, P.REF_SLOTS
    dy = rng.randint(0, 256, (S, H, W)).astype(np.int16)
    dcb = rng.randint(0, 256, (S, H // 2, W // 2)).astype(np.int16)
    dcr = rng.randint(0, 256, (S, H // 2, W // 2)).astype(np.int16)
    ty, tc = J.init_tables(cj)
    for s in range(S):
        ty, tc = J.update_tables(ty, tc, jnp.asarray(dy[s]),
                                 jnp.asarray(dcb[s]), jnp.asarray(dcr[s]),
                                 np.int32(s), cj)
    return dy, dcb, dcr, np.asarray(ty), np.asarray(tc)


_JAX_PROGRAM = {}


def _jax_decode(state, t, slot, cfg, stages):
    from libde265_tpu import frame_program as J
    if "f" not in _JAX_PROGRAM:
        _JAX_PROGRAM["f"] = jax.jit(J.decode_frame_device,
                                    static_argnames=("cfg", "stages"))
    return _JAX_PROGRAM["f"](*(jnp.asarray(a) for a in state),
                             {k: jnp.asarray(v) for k, v in t.items()},
                             np.int32(slot), cfg=cfg, stages=stages)


def _stage_case(monkeypatch, idr):
    """(JAX cfg, port cfg, plan, fid_slot, out slot) of p_mv's IDR
    (idr) or first P frame, the IDR's cfgs with the intra stage."""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import packing as P
    plans = _plans("p_mv")
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    if idr:
        return (dataclasses.replace(cj, skip_mc=True),
                dataclasses.replace(cp, skip_mc=True), plans[0],
                {plans[0].frame_id: 0}, 0)
    return (dataclasses.replace(cj, intra=(), intra_C=0),
            dataclasses.replace(cp, intra=(), intra_C=0), plans[1],
            {plans[0].frame_id: 2, plans[1].frame_id: 6}, 6)


@pytest.mark.parametrize("case", [("p", v) for v in VARIANTS]
                         + [("idr", ("all", None)),
                            ("idr", ("no_intra", ("mc", "res", "dbk", "sao",
                                                  "tables")))],
                         ids=lambda c: f"{c[0]}-{c[1][0]}")
def test_stages_match_jax(case, monkeypatch):
    """decode_frame_device(stages=...) on p_mv's first P frame for each
    of profile_frame_stages' seven variants, and on its IDR with and
    without "intra" (None: the default), from the same seeded DPB state
    and packed plan as the JAX program's: identical DPB stacks and tile
    tables."""
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import frame_program as F
    from libde265_tpu_torch.convert import plan_from_numpy, state_from_numpy
    kind, (_, stages) = case
    cj, cp, plan, fid_slot, slot = _stage_case(monkeypatch, kind == "idr")
    state = _seeded_state(cj, cp, 11)
    t = J.pack_frame(plan, cj, fid_slot, real_slots=True)
    jst = J.decode_frame_device.__defaults__[0] if stages is None \
        else stages
    want = _jax_decode(state, t, slot, cj, jst)
    kw = {} if stages is None else {"stages": stages}
    got = F.decode_frame_device(*state_from_numpy(*state, "cpu"),
                                plan_from_numpy(t, "cpu"), slot, cp, **kw)
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), what
    if stages is not None and "tables" not in stages:
        # no table update: the tables are the seeded ones
        assert np.array_equal(got[3].numpy(), state[3])


def test_default_stages_are_the_jax_default():
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import frame_program as F
    assert F.STAGES == J.decode_frame_device.__defaults__[0]
    assert VARIANTS[-1][1] == tuple(s for s in F.STAGES if s != "intra")


def _jax_blobs(monkeypatch):
    """The JAX pack_blob of p_mv's IDR batch and P batch under bench's
    static slot map (IDR in slot 0, P frames 1..7)."""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    from libde265_tpu import frame_program as J
    plans = _plans("p_mv")
    cfg = J.stream_cfg(plans, plans[0].sps)
    iframes = [p for p in plans if J.frame_has_intra(p)]
    pframes = [p for p in plans if not J.frame_has_intra(p)]
    fid_slot = static_slot_map({"i": iframes, "p": pframes})
    out = []
    for pl, c in ((iframes, dataclasses.replace(cfg, skip_mc=True)),
                  (pframes, dataclasses.replace(cfg, intra=(), intra_C=0))):
        pk = [J.pack_frame(p, c, fid_slot, real_slots=True) for p in pl]
        st = {k: np.stack([t[k] for t in pk]) for k in pk[0]}
        out.append(J.pack_blob(st, *J.blob_meta(st)))
    return out


def _psm():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def test_bench_protocol_matches_jax(monkeypatch):
    """tools.bench on p_mv (--device cpu --rounds 2 --workers 2): the
    MD5-checked round passes, the JSON line has every key, every blob it
    uploads equals the JAX pack_blob of the same frames byte for byte
    (the 16 of the pipelined rounds came through the workers' shared
    memory), the workers report no CUDA context, no jax and torch
    imported only after their environment was set, and no segment of
    the run is left under /dev/shm."""
    from libde265_tpu_torch import device_stream
    from libde265_tpu_torch.tools import bench
    want = _jax_blobs(monkeypatch)
    monkeypatch.delenv("DE265_INTRA_SCAN")
    uploads = []
    real = device_stream._StagingRing.upload

    def upload(self, i, views):
        uploads.append({dt: v.numpy().copy() for dt, v in views.items()})
        return real(self, i, views)

    monkeypatch.setattr(device_stream._StagingRing, "upload", upload)
    before = _psm()
    rc, out = port_tool("bench", ["--stream", "p_mv", "--manifest",
                                  "manifest_inter.json", "--device", "cpu",
                                  "--rounds", "2", "--workers", "2"])
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == set(bench.JSON_KEYS)
    assert res["metric"] == "cpu_4k_e2e_decode_fps" and res["device"] == "cpu"
    assert res["device_busy_fps"] is None and res["device_busy_share"] is None
    assert res["frames_timed"] == (2 + 8) * 4
    assert len(res["round_launches"]["pipelined"]) == 8
    # verification 1, serial 2, pipelined 8, upload-rate 2 rounds; each
    # the IDR batch, then the P batch
    assert len(uploads) == 2 * (1 + 2 + 8 + 2)
    for k, got in enumerate(uploads):
        ref = want[k % 2]
        assert sorted(got) == sorted(ref)
        for dt in ref:
            assert got[dt].tobytes() == ref[dt].tobytes(), (k, dt)
    assert [w["rounds"] for w in res["workers"]] == [4, 4]
    for w in res["workers"]:
        assert not (w["cuda_initialized"] or w["jax_imported"]
                    or w["torch_imported_first"]), w
    assert res["shm_segments_left"] == 0 and _psm() <= before


def test_bench_worker_death_fails_the_run(monkeypatch):
    """A pack worker that dies fails the pipelined rounds at once (its
    exit code is read, it is not waited out) and its segments are
    removed by the consumer."""
    from libde265_tpu_torch.tools import bench
    plans = _plans("p_mv")
    b = bench.Bench(os.path.join(DATA, "p_mv.bin"), plans,
                    torch.device("cpu"))
    b.pack()
    b.path = os.path.join(DATA, "no_such_stream.bin")   # workers fail
    before = _psm()
    try:
        with pytest.raises(RuntimeError, match="exited with code"):
            b.pipelined_rounds(2, 2)
    finally:
        b.close()
    assert _psm() <= before


def test_bench_frontend_counts_match_jax(tmp_path, monkeypatch):
    """bench_frontend on p_2ref counts the JAX tool's frames (and the JAX
    package's plans), geometry and rate, and writes its JSON lines only
    to the path it is given (stdout empty, FRONTEND.json untouched)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    monkeypatch.syspath_prepend(REPO)
    import bench_frontend as jaxtool
    from bench import parse_stream
    front = os.path.join(REPO, "FRONTEND.json")
    with open(front, "rb") as f:
        front_before = f.read()
    out = tmp_path / "fe.jsonl"
    monkeypatch.chdir(tmp_path)
    rc, so = port_tool("bench_frontend", [str(out), "--streams", "p_2ref",
                                          "--reps", "1"])
    assert rc == 0 and so == ""
    assert os.listdir(tmp_path) == ["fe.jsonl"]
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    with open(os.path.join(DATA, "p_2ref.bin"), "rb") as f:
        nplans = len(parse_stream(f.read()))
    assert len(rows) == 2
    for row, threads in zip(rows, (1, 4)):
        ref = jaxtool.bench("p_2ref", threads, reps=1)
        assert row["threads"] == threads
        for k in ("stream", "frames", "w", "h"):
            assert row[k] == ref[k], k
        assert round(row["mbps"], 1) == ref["mbps"]
        assert row["plans"] == nplans
    with open(front, "rb") as f:
        assert f.read() == front_before


def test_bench_intra_scan_paths_agree():
    """bench_intra_scan --fori on p_mv's IDR: the band scan's picture
    matches the manifest and the wavefront-level path's picture."""
    rc, out = port_tool("bench_intra_scan", [
        "p_mv", "--fori", "--manifest", "manifest_inter.json", "--device",
        "cpu"])
    assert rc == 0
    assert "MD5 MATCH" in out and "pictures EQUAL" in out


@pytest.mark.parametrize("name,argv", [
    ("bench_e2e", [os.path.join(DATA, "p_mv.bin"), "device", "1"]),
    ("bench_e2e", [os.path.join(DATA, "p_mv.bin"), "numpy", "1"]),
    ("profile_frame_stages", ["p_mv", "--manifest", "manifest_inter.json",
                              "--rounds", "1"]),
    ("profile_intra", ["p_mv", "--reps", "1"]),
    ("bench_full_pipeline", ["--iters", "2", "--height", "64",
                             "--width", "128"]),
    ("bench_gop_device", ["--stream", "p_mv", "--manifest",
                          "manifest_inter.json"]),
])
def test_tool_runs_on_cpu(name, argv):
    """Each other measurement tool at a small size on the CPU: exit 0;
    the JSON line's verdicts (profile_frame_stages: the full variant's
    state equals the default call's, every frame MD5-equal; the GOP
    tool: no copy)."""
    rc, out = port_tool(name, [*argv, "--device", "cpu"])
    assert rc == 0, out
    last = out.strip().splitlines()[-1]
    if name == "bench_e2e":
        assert "4 frames" in last
        return
    res = json.loads(last)
    if name == "profile_frame_stages":
        assert res["full_equals_default"] and not \
            res["default_md5_mismatch_pocs"]
        assert len(out.strip().splitlines()) == len(VARIANTS) + 1
    if name == "bench_gop_device":
        assert (res["peer_copies"], res["d2d_copies"]) == (0, 0)


def test_tools_ask_for_cuda_by_default():
    """Without --device a tool asks for the card, and where there is
    none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        port_tool("bench_full_pipeline", ["--iters", "1", "--height", "64",
                                          "--width", "128"])
