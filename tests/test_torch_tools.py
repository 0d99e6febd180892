"""The port's command-line tools (libde265_tpu_torch/tools/) against the
JAX package's (tools/*.py) on the same inputs, the port's with
--device cpu: the same YUV bytes, stdout (the measured fps aside),
statuses, pixels and values. Both run in-process; the JAX tools'
decodes are numpy's (their default), the port's its device path on the
CPU. tools/gen_torch_tools_goldens.py's cheap entries are rebuilt and
held to tests/data/manifest_torch_tools.json, the file the card's run
(chip_smoke.py phase 19) is held to."""
import contextlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA = os.path.join(TESTS, "data")
sys.path.insert(0, os.path.join(REPO, "tools"))

import gen_torch_tools_goldens as G  # noqa: E402


def port_tool(name, argv):
    """(exit code, stdout) of libde265_tpu_torch.tools.<name>.main."""
    mod = importlib.import_module(f"libde265_tpu_torch.tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue()


def no_fps(stdout):
    return re.sub(r"@ [0-9.]+ fps", "@ fps", stdout)


def _stream(name):
    return os.path.join(DATA, name + ".bin")


def _dec265_pair(tmp_path, argv, monkeypatch):
    """(JAX rc, stdout, YUV bytes), (port rc, stdout, YUV bytes) of
    dec265 with argv plus -o; the kill-switch environment is restored
    after each."""
    out = []
    for side in ("jax", "port"):
        for k in ("DE265_DISABLE_DEBLOCK", "DE265_DISABLE_SAO"):
            monkeypatch.delenv(k, raising=False)
        yuv = tmp_path / f"{side}.yuv"
        args = [*argv, "-o", str(yuv)]
        rc, so = (G.jax_tool("dec265", args) if side == "jax" else
                  port_tool("dec265", [*args, "--device", "cpu"]))
        out.append((rc, no_fps(so), yuv.read_bytes() if yuv.exists()
                    else b""))
    return out


# 4:2:0 8 and 10 bits, 4:2:2, 4:4:4, monochrome, a B stream, a stream
# on the hybrid path and one on the numpy route
DEC265_VECTORS = ("intra_64x64_q27", "p_10bit", "rext_422_104x72",
                  "rext_444_104x72", "rext_mono_104x72", "b_mixed",
                  "rxt_cqo", "rxt_ccp_444")


@pytest.mark.parametrize("name", DEC265_VECTORS)
def test_dec265_yuv_matches_jax(name, tmp_path, monkeypatch):
    jax, port = _dec265_pair(tmp_path, [_stream(name)], monkeypatch)
    assert port == jax and jax[0] == 0 and len(jax[2])


@pytest.mark.parametrize("name,argv", [
    ("p_hash_sei", ["-c"]),
    ("p_temporal", ["-T", "0"]),
    ("p_temporal", ["-F", "50"]),
    ("b_mv", ["--frames", "2"]),
    ("intra_64x64_q27", ["-m", os.path.join(DATA,
                                            "intra_64x64_q37_gold.yuv")]),
])
def test_dec265_options_match_jax(name, argv, tmp_path, monkeypatch):
    jax, port = _dec265_pair(tmp_path, [*argv, _stream(name)], monkeypatch)
    assert port == jax and jax[0] == 0
    if argv[0] == "-m":
        assert "PSNR Y" in port[1]


@pytest.mark.parametrize("name", ["rxt_cqo_10b", "rxt_rice_scaling_10b"])
def test_dec265_hash_check_10bit_reference_fault(name, tmp_path,
                                                 monkeypatch):
    """-c on the 10-bit vectors with hash SEI: the JAX tool checks its
    native route's pictures at 8 bits and reports every frame as a
    mismatch (ROADMAP queue 3); the port checks each coded picture at
    its bit depth and passes. The pictures are the same."""
    jax, port = _dec265_pair(tmp_path, ["-c", _stream(name)], monkeypatch)
    assert jax[:2] == (1, "HASH MISMATCH on 3 frame(s)\n")
    assert port[0] == 0 and port[1].startswith("nFrames decoded: 3 ")
    jax, port = _dec265_pair(tmp_path, [_stream(name)], monkeypatch)
    assert jax == port


def test_dec265_hash_mismatch_exits_1(tmp_path, monkeypatch):
    """-c on a stream whose hash SEI no longer matches: both tools print
    HASH MISMATCH and exit 1."""
    data = bytearray(open(_stream("p_hash_sei"), "rb").read())
    # flip a bit inside the last picture-hash payload (its MD5 bytes)
    at = bytes(data).rfind(b"\x00\x00\x01\x50")        # suffix SEI NAL
    assert at > 0
    data[at + 10] ^= 0x10
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(data))
    jax, port = _dec265_pair(tmp_path, ["-c", str(bad)], monkeypatch)
    assert jax[:2] == port[:2] == (1, "HASH MISMATCH on 1 frame(s)\n")


def test_decodestreams_statuses_match_jax(tmp_path):
    """The sweep over a directory of six small vectors (with the
    manifests that list them) and three fuzzed files (id_063's damaged
    plan is refused by decode_stream_native's packing and recovered by
    the segment push decoder): the same status per stream and the same
    summary."""
    for n in ("intra_64x64_q27", "p_mixed", "b_mv", "p_10bit",
              "rext_422_104x72", "rxt_cqo", "id_001_intra_64x64_q27_flip1",
              "id_003_intra_64x64_q27_trunc0", "id_063_p_slices2_flip0"):
        shutil.copy(_stream(n), tmp_path)
    for mf in ("manifest.json", "manifest_inter.json", "manifest_rext.json"):
        shutil.copy(os.path.join(DATA, mf), tmp_path)
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "decodestreams.py"),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rc, so = port_tool("decodestreams", [str(tmp_path), "--device", "cpu"])

    def kinds(stdout):
        return [re.sub(r"\(allowed\): .*", "(allowed)", ln)
                for ln in stdout.splitlines()]
    assert rc == 0 and kinds(so) == kinds(r.stdout)
    assert so.strip().endswith("9/9 streams OK")
    assert "id_063_p_slices2_flip0: OK" in so.splitlines()
    assert sum(": OK" in ln for ln in so.splitlines()) >= 7


def test_decodestreams_fuzz_statuses():
    """The fuzzed files the JAX sweep over tests/data failed on (the
    committed golden): the port's sweep fails on them too, but for
    SWEEP_BETTER, which it decodes."""
    from libde265_tpu_torch.tools.decodestreams import check_one
    with open(G.OUT) as f:
        not_ok = json.load(f)["decodestreams"]["not_ok"]
    assert set(G.SWEEP_BETTER) <= set(not_ok)
    for name in not_ok:
        _, st = check_one((name, _stream(name), None, "cpu"))
        assert (st == "OK") == (name in G.SWEEP_BETTER), (name, st)
        assert st == "OK" or st.startswith("FUZZ-FAIL (allowed): ")


def test_acceleration_speed_check():
    """The checks pass, with the JAX tool's lines."""
    rc, so = port_tool("acceleration_speed", ["--device", "cpu"])
    want = [f"transform {n}x{n}: OK" for n in (4, 8, 16, 32)] + \
        [f"mc_luma {n}x{n}: OK" for n in (8, 16, 32, 64)] + \
        ["all kernels verified against scalar reference"]
    assert rc == 0 and so.splitlines() == want


def test_acceleration_speed_mc_motion_field():
    """pu_motion places each PU in its own cell with the motion that
    reads its reference position at its phases."""
    from libde265_tpu_torch.tools.acceleration_speed import pu_motion
    xs, ys = np.array([-8, 100, 479]), np.array([5, -8, 300])
    fx, fy = np.array([1, 2, 3]), np.array([3, 0, 1])
    mv, where = pu_motion(xs, ys, fx, fy, 64, 64, 128)
    assert mv.shape == (1, 32 * 32, 2, 2) and where == [
        (0, 0, 0), (0, 64, 0), (0, 0, 64)]
    grid = mv[0].reshape(32, 32, 2, 2)
    for i, (k, px, py) in enumerate(where):
        blk = grid[py // 4:py // 4 + 16, px // 4:px // 4 + 16, 0]
        assert (blk[..., 0] >> 2 == xs[i] - px).all()
        assert (blk[..., 0] & 3 == fx[i]).all()
        assert (blk[..., 1] >> 2 == ys[i] - py).all()
        assert (blk[..., 1] & 3 == fy[i]).all()


def _pixels(png):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(png)))


def test_sherlock_layers_match_jax(tmp_path):
    """Every layer's decoded pixels (PIL) and the frame metadata equal
    the JAX tool's; the report holds the player's parts."""
    args = [_stream("p_cif_mixed"), "-n", "2"]
    rc, _ = G.jax_tool("sherlock", [*args, "-o", str(tmp_path / "j.html")])
    assert rc == 0
    rc, so = port_tool("sherlock", [*args, "-o", str(tmp_path / "p.html"),
                                    "--device", "cpu"])
    assert rc == 0 and "2 frames, layers: cb, tb, mv, qp, slice" in so
    html = (tmp_path / "p.html").read_text()
    for needle in ('id="fr"', 'ck_cb', 'ck_mv', '"base"', 'image/png'):
        assert needle in html, needle
    got, meta = G.html_images(html)
    want, jmeta = G.html_images((tmp_path / "j.html").read_text())
    assert meta == jmeta and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["base", "cb", "tb", "mv", "qp",
                                      "slice"]
        for k in g:
            a, b = _pixels(g[k]), _pixels(w[k])
            assert a.shape == b.shape and np.array_equal(a, b), k


def test_png_bytes_round_trip():
    """png_bytes of RGB and RGBA arrays decodes to the array, by PIL and
    by the zlib decoder the card's run uses (filter0_pixels), which
    refuses the JAX tool's filtered PNGs."""
    from PIL import Image
    from libde265_tpu_torch.tools.sherlock import png_bytes
    rng = np.random.RandomState(5)
    for c in (3, 4):
        a = rng.randint(0, 256, (7, 11, c)).astype(np.uint8)
        assert np.array_equal(_pixels(png_bytes(a)), a)
        assert np.array_equal(G.filter0_pixels(png_bytes(a)), a)
    smooth = np.tile(np.arange(64, dtype=np.uint8), (8, 1))[..., None] \
        .repeat(3, 2)
    buf = io.BytesIO()
    Image.fromarray(smooth).save(buf, format="PNG", optimize=True)
    with pytest.raises(ValueError, match="filter"):
        G.filter0_pixels(buf.getvalue())


def test_hdrcopy_matches_jax(tmp_path):
    src = _stream("p_temporal")
    outs = []
    for side in ("jax", "port"):
        cp = str(tmp_path / f"{side}.bin")
        argv = [src, "--slices", "--copy", cp]
        rc, so = G.jax_tool("hdrcopy", argv) if side == "jax" \
            else port_tool("hdrcopy", argv)
        outs.append((rc, so.replace(cp, "OUT"), open(cp, "rb").read()))
    assert outs[0] == outs[1]
    assert "SPS" in outs[1][1] and "slice" in outs[1][1]


def test_enc265_matches_jax(tmp_path):
    """A seeded 64x64 4-frame YUV: the same stream bytes and line."""
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(G.tools_yuv(7, 64, 64, 4))
    outs = []
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.bin")
        argv = ["-i", str(yuv), "-o", out, "-w", "64", "-h", "64",
                "--qp", "30", "--sao", "--deblock"]
        rc, so = G.jax_tool("enc265", argv) if side == "jax" \
            else port_tool("enc265", argv)
        outs.append((rc, so, open(out, "rb").read()))
    assert outs[0] == outs[1] and outs[0][1] == \
        f"encoded 4 frames -> {len(outs[0][2])} bytes\n"


def test_rd_curves_matches_jax(tmp_path):
    """Two QPs: the same points (the port decodes on its device path)."""
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(G.tools_yuv(7, 64, 64, 4))
    argv = ["-i", str(yuv), "-w", "64", "-h", "64", "--qps", "27,37"]
    jrc, jso = G.jax_tool("rd_curves", argv)
    rc, so = port_tool("rd_curves", [*argv, "--device", "cpu"])
    assert (rc, so) == (jrc, jso) and len(json.loads(
        so.splitlines()[-1])) == 2


def test_bjontegaard_matches_jax(tmp_path):
    """The committed curves a and b: the same BD-PSNR and BD-rate lines,
    and the same values from the functions."""
    from libde265_tpu_torch.tools import bjontegaard as B
    with open(G.OUT) as f:
        rd = json.load(f)["seeded"]["rd_curves"]
    paths = []
    for k in ("a", "b"):
        p = tmp_path / f"{k}.json"
        p.write_text(json.dumps(rd[k]["points"]))
        paths.append(str(p))
    jrc, jso = G.jax_tool("bjontegaard", paths)
    rc, so = port_tool("bjontegaard", paths)
    assert (rc, so) == (0, jso) and so.startswith("BD-PSNR: ")
    import bjontegaard as JB
    a, b = rd["a"]["points"], rd["b"]["points"]
    assert B.bd_psnr(a, b) == JB.bd_psnr(a, b)
    assert B.bd_rate(a, b) == JB.bd_rate(a, b)


def test_tools_goldens_current(tmp_path):
    """tools/gen_torch_tools_goldens.py's cheap entries rebuild the
    committed file's, and its kill-switch entry of p_filters."""
    with open(G.OUT) as f:
        committed = json.load(f)
    got = G.cheap(str(tmp_path))
    for k, v in got.items():
        assert committed[k] == v, k
    assert G.killswitch(str(tmp_path), ("p_filters",))["p_filters"] == \
        committed["killswitch"]["p_filters"]
    assert set(committed["killswitch"]) == set(G.KILLSWITCH)
    ds = committed["decodestreams"]
    assert ds["other"] == 0 and ds["summary"] == \
        f"{ds['ok'] + ds['fuzz']}/{ds['ok'] + ds['fuzz']} streams OK"
