"""The whole slice through the port (libde265_tpu_torch, CPU tensors: the
kernels' plain versions) against the dec265 MD5s of the manifests, and
its final device state (DPB stacks, MC tile tables, slot map) against the
JAX package's DeviceStreamDecoder on the same parsed plans."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = ["p_mv", "b_mv", "p_sao", "p_deblk", "intra_64x64_q27",
           "i_deblk_sao", "p_wp", "adv_b_wp_2ref",
           # every other small vector that check_slice accepts
           "b_2pu_merge", "b_cabacinit", "b_mixed", "b_mvdl1zero",
           "b_reflist_mod", "i_strong32", "p_2pu", "p_2pu_amp",
           "p_2pu_filters", "p_2pu_merge", "p_2ref", "p_bigmv",
           "p_cabacinit", "p_cif_mixed", "p_cip", "p_cra", "p_cu8",
           "p_depslices", "p_filters", "p_hash_sei", "p_ltr", "p_mixed",
           "p_mixedlf", "p_mvres", "p_qpdelta", "p_qpoff", "p_reflist_mod",
           "p_sdh", "p_skip", "p_slices2", "p_slices2wpp", "p_temporal",
           "p_tiles22", "p_tiles2_mv", "p_tiles2_mv_nolf", "p_tiles3r_mv",
           "p_tiles4_mv", "p_tiles8_mv", "p_tiles8nu_mv", "p_tiles_nolf",
           "p_tmvp", "p_ttsplit", "p_wppx", "adv_w1_wpp", "adv_w1_wpp_dep",
           "rext_420_nxn", "rxt_irdpcm", "rxt_rice", "rxt_rot", "rxt_tsctx",
           "intra_104x72_q26", "intra_64x64_q37", "intra_cif_maxcb64",
           "intra_cif_q20_nxn", "intra_cif_q30",
           # the 4:2:0 residual tools: transform-skip, transquant bypass,
           # PCM, scaling lists
           "p_tskip", "p_tqbypass", "i_tskip_nxn", "p_pcm", "p_pcm_nolf",
           "p_scaling", "adv_lossless_tskip_partial", "adv_rice_tiles",
           "adv_tiles_lossless", "adv_dep_pcm_strong",
           "adv_ltr_tsa_scaling",
           # 4:2:0 above 8 bits (uint16 pictures, int16 tile tables)
           "p_10bit", "rext_420_inter_12b", "rxt_rice_scaling_10b",
           "adv_cra_scaling_10b_amp", "adv_wpp_dep10_scaling"]
# accepted vectors with frames that frame_compatible rejects (range-
# extension residual tools, TU-level chroma QP offsets): the numpy
# reference reconstructs those that frame_uses_rext_tools flags and the
# hybrid device path the others, into the device DPB
HOST_FRAMES = {"adv_rot_tsctx_wpp": 1, "adv_cqo_tiles": 4, "rxt_cqo": 4,
               "rxt_kitchen": 4, "rxt_smooth_off": 3,
               # explicit RDPCM in every P frame
               "adv_erdpcm_dep": 3, "rxt_erdpcm": 3,
               "rxt_erdpcm_rot_tsctx": 3,
               # 10-bit, TU-level chroma QP offsets in every frame
               "rxt_cqo_10b": 3}


def _manifest(name):
    mf = {"intra_": "manifest.json", "adv_": "manifest_adv.json",
          "rext_": "manifest_rext.json",
          "rxt_": "manifest_rext_tools.json"}.get(
        name[:name.index("_") + 1], "manifest_inter.json")
    with open(os.path.join(DATA, mf)) as f:
        return json.load(f)[name]


def _data(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,host_frames",
                         [(n, 0) for n in STREAMS]
                         + list(HOST_FRAMES.items()))
def test_decode_md5(name, host_frames):
    """host_frames: frames frame_compatible rejects (adv_rot_tsctx_wpp
    uses transform-skip rotation in one frame), which the numpy reference
    (the frames frame_uses_rext_tools flags) or the hybrid device path
    (the others) reconstructs into the device DPB between frame-program
    frames."""
    from libde265_tpu_torch.api import _parse, decode_stream_native
    from libde265_tpu_torch.packing import (frame_compatible,
                                            frame_uses_rext_tools)
    m = _manifest(name)
    st = {}
    pics = decode_stream_native(_data(name), device="cpu", stats=st)
    assert len(pics) == m["frames"]
    plans = _parse(_data(name))
    assert host_frames == sum(not frame_compatible(p) for p in plans)
    rext = sum(frame_uses_rext_tools(p) for p in plans)
    assert (st["n_host_frames"], st["n_hybrid_frames"]) == \
        (rext, host_frames - rext)
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i}"


@pytest.mark.parametrize("name", ["b_mv", "p_deblk", "i_deblk_sao", "p_wp"])
def test_final_state_matches_jax(name, monkeypatch):
    """Same plans through both decoders: identical DPB stacks, tile
    tables (pad rows included) and slot assignment."""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    from libde265_tpu.device_stream import DeviceStreamDecoder as JaxDec
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    plans = _parse(_data(name))
    jd = JaxDec(plans, plans[0].sps)
    jd.decode_all()
    pd = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    pd.decode_all()
    assert pd.slot_of == jd.slot_of
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), pd.state(),
                          (jd.dy, jd.dcb, jd.dcr, jd.ty, jd.tc)):
        b = np.asarray(b)
        assert a.dtype == getattr(torch, b.dtype.name), what
        assert np.array_equal(a.numpy(), b), what


def test_frame_program_matches_jax():
    """One P frame of p_sao through both frame programs, from the same
    seeded DPB state (state_from_numpy) and the same packed plan
    (plan_from_numpy): identical DPB stacks and tile tables after it."""
    import dataclasses
    import jax.numpy as jnp
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import frame_program as F
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.convert import plan_from_numpy, state_from_numpy
    plans = _parse(_data("p_sao"))
    cj = dataclasses.replace(J.stream_cfg(plans, plans[0].sps), intra=(),
                             intra_C=0)
    cp = dataclasses.replace(P.stream_cfg(plans, plans[0].sps), intra=(),
                             intra_C=0)
    rng = np.random.RandomState(5)
    H, W, S = cp.H, cp.W, P.REF_SLOTS
    dy = rng.randint(0, 256, (S, H, W)).astype(np.int16)
    dcb = rng.randint(0, 256, (S, H // 2, W // 2)).astype(np.int16)
    dcr = rng.randint(0, 256, (S, H // 2, W // 2)).astype(np.int16)
    ty, tc = J.init_tables(cj)
    for s in range(S):
        ty, tc = J.update_tables(ty, tc, jnp.asarray(dy[s]),
                                 jnp.asarray(dcb[s]), jnp.asarray(dcr[s]),
                                 np.int32(s), cj)
    ty, tc = np.asarray(ty), np.asarray(tc)
    plan = plans[1]                       # refers to plans[0] only
    fid_slot = {plans[0].frame_id: 2, plan.frame_id: 6}
    t = J.pack_frame(plan, cj, fid_slot, real_slots=True)
    want = J.get_program(cj)(
        *(jnp.asarray(a) for a in (dy, dcb, dcr, ty, tc)),
        {k: jnp.asarray(v) for k, v in t.items()}, np.int32(6))
    got = F.decode_frame_device(*state_from_numpy(dy, dcb, dcr, ty, tc,
                                                  "cpu"),
                                plan_from_numpy(t, "cpu"), 6, cp)
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), what


def test_port_runs_without_jax():
    """Importing every module of the port (parallel.tile_shard,
    parallel.gop_shard, parallel.gop_parallel, the push API's decoder,
    errors and bitstream.sei, and the hybrid path's device_decode,
    backend, intra_wavefront, ops.inter, ops.inter_dense, ops.intra and
    ops.filters_fused among them) and decoding small streams on the CPU,
    one of them through the numpy host path, one through the hybrid
    device path, one at 10 bits, one through the pipelined decoder, one
    through the tile-column decoder, one through the GOP decoder (and
    decode_gop_parallel) and one through the push API with its SEI hash
    checks, and once more through the per-picture path (parse="python",
    bitstream.ctu.SliceReader); then encoding a small stream with the
    port's encoder (hash
    SEI on), decoding it through the push API with every hash checked,
    scoring it with utils.quality and running parallel.tile_mesh's step,
    then running the command-line tools dec265 (with a kill-switch, so
    on the per-picture path) and hdrcopy (every module of tools/ is
    imported by the walk), leaves jax and the JAX package (libde265_tpu)
    out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import libde265_tpu_torch as pkg\n"
        "walked = set()\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.add(m.name[len(pkg.__name__) + 1:])\n"
        "hybrid = {'device_decode', 'backend', 'intra_wavefront',\n"
        "          'ops.inter', 'ops.inter_dense', 'ops.intra',\n"
        "          'ops.filters_fused'}\n"
        "assert hybrid <= walked, hybrid - walked\n"
        "push = {'parallel.gop_parallel', 'decoder', 'errors',\n"
        "        'bitstream.sei'}\n"
        "assert push <= walked, push - walked\n"
        "from libde265_tpu_torch.api import decode_stream_native\n"
        "for name, n, nh, nhyb in (('i_deblk_sao', 2, 0, 0),\n"
        "                          ('adv_rot_tsctx_wpp', 4, 1, 0),\n"
        "                          ('p_10bit', 3, 0, 0),\n"
        "                          ('adv_erdpcm_dep', 4, 0, 3)):\n"
        "    st = {}\n"
        "    data = open(f'tests/data/{name}.bin', 'rb').read()\n"
        "    pics = decode_stream_native(data, device='cpu', stats=st)\n"
        "    assert (len(pics), st['n_host_frames'],\n"
        "            st['n_hybrid_frames']) == (n, nh, nhyb), name\n"
        "from libde265_tpu_torch.api import _parse\n"
        "from libde265_tpu_torch.device_stream import DeviceStreamDecoder\n"
        "plans = _parse(open('tests/data/p_mv.bin', 'rb').read() * 2)\n"
        "dec = DeviceStreamDecoder(plans, plans[0].sps, 'cpu')\n"
        "dec.decode_all_pipelined(batch=3, keep_outputs=False)\n"
        "assert dec.n_pipelined_frames == 8\n"
        "import libde265_tpu_torch.parallel.tile_shard\n"
        "st = {}\n"
        "data = open('tests/data/p_tiles2_mv.bin', 'rb').read()\n"
        "pics = decode_stream_native(data, stats=st,\n"
        "                            tile_devices=['cpu', 'cpu'])\n"
        "assert (len(pics), st['n_strip_frames']) == (4, 3)\n"
        "data = open('tests/data/p_mv.bin', 'rb').read() * 2\n"
        "pics = decode_stream_native(data, stats=st,\n"
        "                            gop_devices=['cpu', 'cpu'])\n"
        "assert (len(pics), st['n_gops']) == (8, 2)\n"
        "from libde265_tpu_torch.parallel.gop_parallel import \\\n"
        "    decode_gop_parallel\n"
        "frames = decode_gop_parallel(data, devices=['cpu'], stats=st)\n"
        "assert (len(frames), st['route']) == (8, 'device')\n"
        "from libde265_tpu_torch import api\n"
        "dec = api.new_decoder(device='cpu')\n"
        "data = open('tests/data/p_hash_sei.bin', 'rb').read()\n"
        "for i in range(0, len(data), 500):\n"
        "    api.push_data(dec, data[i:i + 500], pts=i)\n"
        "api.flush_data(dec)\n"
        "while api.decode(dec):\n"
        "    pass\n"
        "n = 0\n"
        "while api.get_next_picture(dec) is not None:\n"
        "    n += 1\n"
        "assert (n, dec.hash_checks_passed) == (3, 3), n\n"
        "assert api.get_warning(dec) is None\n"
        "from libde265_tpu_torch.bitstream.ctu import SliceReader\n"
        "dec = api.new_decoder(device='cpu', parse='python')\n"
        "for i in range(0, len(data), 500):\n"
        "    api.push_data(dec, data[i:i + 500], pts=i)\n"
        "api.flush_data(dec)\n"
        "n, more = 0, True\n"
        "while more:\n"
        "    more = api.decode(dec)\n"
        "    while api.get_next_picture(dec) is not None:\n"
        "        n += 1\n"
        "assert (n, dec.hash_checks_passed) == (3, 3), n\n"
        "assert dec.stats['n_frames'] == 3 and dec.stats['parse_s'] > 0\n"
        "assert api.get_warning(dec) is None\n"
        "enc = {'encoder', 'encoder.rdo', 'dpb', 'motion', 'utils.quality',\n"
        "       'utils.visualize', 'utils.configparam', 'parallel.tile_mesh',\n"
        "       'bitstream.cabac', 'bitstream.contextmodel', 'bitstream.ctu'}\n"
        "assert enc <= walked, enc - walked\n"
        "import numpy as np\n"
        "from libde265_tpu_torch.encoder import Encoder, EncoderConfig\n"
        "from libde265_tpu_torch.utils.quality import psnr\n"
        "rng = np.random.RandomState(0)\n"
        "src = [[rng.randint(0, 256, s).astype(np.uint8)\n"
        "        for s in ((64, 64), (32, 32), (32, 32))] for _ in range(2)]\n"
        "cfg = EncoderConfig(inter_mode='mixed', inter_residual=True,\n"
        "                    write_hash_sei=True, sao=True)\n"
        "data = Encoder(cfg).encode(src)\n"
        "dec = api.new_decoder(device='cpu')\n"
        "api.push_data(dec, data)\n"
        "api.flush_data(dec)\n"
        "while api.decode(dec):\n"
        "    pass\n"
        "pics = []\n"
        "while (p := api.get_next_picture(dec)) is not None:\n"
        "    pics.append(p)\n"
        "assert (len(pics), dec.hash_checks_passed) == (2, 2)\n"
        "assert 10 < psnr(pics[0].planes[0], src[0][0]) < 99\n"
        "from libde265_tpu_torch.parallel import tile_mesh\n"
        "inp = tile_mesh.demo_inputs(32, 64, 2, 8)\n"
        "out, s = tile_mesh.make_tile_recon_step(['cpu'] * 2, 32, 64, 2,\n"
        "                                        8)(*inp)\n"
        "assert int(s) == int(out.sum())\n"
        "tools = {'tools.' + t for t in ('dec265', 'enc265',\n"
        "         'decodestreams', 'acceleration_speed', 'sherlock',\n"
        "         'hdrcopy', 'rd_curves', 'bjontegaard')}\n"
        "assert tools <= walked, tools - walked\n"
        "import contextlib, io\n"
        "from libde265_tpu_torch.tools import dec265, hdrcopy\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    assert dec265.main(['-c', '--disable-sao', '--device', 'cpu',\n"
        "                        'tests/data/p_hash_sei.bin']) == 0\n"
        "    assert hdrcopy.main(['tests/data/p_temporal.bin']) == 0\n"
        "assert 'nFrames decoded: 3 (64x64 @ ' in buf.getvalue()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'libde265_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cuda_request_raises_without_a_card():
    """device='cuda' where there is no card raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from libde265_tpu_torch.api import decode_stream_native
    with pytest.raises(RuntimeError, match="cuda"):
        decode_stream_native(_data("i_deblk_sao"), device="cuda")


@pytest.mark.parametrize("name", ["p_wp", "b_mv", "adv_rot_tsctx_wpp",
                                  "intra_104x72_q26"])
def test_frontend_copy_matches_jax_package(name):
    """The port's copy of the host front end (native_frontend, bitstream,
    plan) against the JAX package's: the same stream parsed by each gives
    the same stream_cfg and byte-identical packed frames."""
    import dataclasses
    from libde265_tpu import native_frontend as JN
    from libde265_tpu.bitstream import nal as JB, paramsets as JP
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.api import _parse
    data = _data(name)
    spss, ppss = {}, {}
    for u in JB.split_annexb(data):
        if u.header.nal_unit_type == 33:
            sp = JP.read_sps(u.data)
            spss[sp.seq_parameter_set_id] = sp
        elif u.header.nal_unit_type == 34:
            pp = JP.read_pps(u.data, spss)
            ppss[pp.pic_parameter_set_id] = pp
    jplans = JN.NativeFrontend().parse(data, spss, ppss)
    pplans = _parse(data)
    assert len(jplans) == len(pplans)
    cj = P.stream_cfg(jplans, jplans[0].sps)
    cp = P.stream_cfg(pplans, pplans[0].sps)
    assert cj == cp
    variants = [cp, dataclasses.replace(cp, intra=(), intra_C=0),
                dataclasses.replace(cp, skip_mc=True)]
    fid_slot = {p.frame_id: i % P.REF_SLOTS for i, p in enumerate(pplans)}
    n = 0
    for jp, pp in zip(jplans, pplans):
        assert (jp.frame_id, jp.poc, jp.nal_type) == \
            (pp.frame_id, pp.poc, pp.nal_type)
        assert P.frame_compatible(jp) == P.frame_compatible(pp)
        if pp.nal_type == -1 or not P.frame_compatible(pp):
            continue
        for cfg in variants:
            if (cfg.skip_mc and P.frame_has_mc(pp)) or \
                    (not cfg.intra and P.frame_has_intra(pp)):
                continue
            tj = P.pack_frame(jp, cfg, fid_slot)
            tp = P.pack_frame(pp, cfg, fid_slot)
            assert sorted(tj) == sorted(tp), name
            if "wt" in tj:
                # weights of inactive reference indices: uninitialised in
                # the JAX package's plans, zero in the port's
                act = np.zeros(tj["wt"].shape[:3], bool)
                for si, sh in enumerate(pp.slice_headers):
                    act[si, 0, :sh.num_ref_idx_l0_active] = True
                    act[si, 1, :sh.num_ref_idx_l1_active] = True
                assert np.array_equal(tj["wt"][act], tp["wt"][act])
                assert not tp["wt"][~act].any()
                del tj["wt"], tp["wt"]
            for k in tj:
                assert tj[k].dtype == tp[k].dtype and \
                    tj[k].tobytes() == tp[k].tobytes(), (name, k)
            n += 1
    assert n >= 1


def test_profile_summary_counts(tmp_path):
    """profile_frames.summarize on a made-up trace of 2 frames: device
    busy is the union of kernel/memcpy intervals, each stage's span,
    busy time and kernel count are per frame (a "de265." range counts
    under its stage's name), and each idle gap goes to the innermost
    "de265.*" host range that holds it."""
    from libde265_tpu_torch.profile_frames import summarize
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 50, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 300,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "j", "ts": 1000, "dur": 400},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "mc", "ts": 0,
           "dur": 500},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "de265.mc",
           "ts": 1000, "dur": 500},
          {"ph": "X", "cat": "user_annotation", "name": "de265.frame",
           "ts": 100, "dur": 900},
          {"ph": "X", "cat": "user_annotation", "name": "de265.sync",
           "ts": 500, "dur": 300}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy, nk, stages, top, idle = summarize(str(path), 2)
    assert busy == pytest.approx(0.325)          # (150 + 100 + 400) us / 2
    assert nk == 1.5
    span, kms, kn = stages["mc"]
    assert span == pytest.approx(0.5) and kms == pytest.approx(0.325)
    assert kn == 1.5
    assert top[0][0] == "j"
    # gaps 150-300, 400-1000 and 1400-1500 us (the trace ends with the
    # stage range): sync holds 500-800, frame the rest of the first two
    assert idle == pytest.approx({"frame": 0.225, "sync": 0.15,
                                  "none": 0.05})
