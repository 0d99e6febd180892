"""The hybrid device path (libde265_tpu_torch/device_decode.py) on CPU
tensors against the JAX package, exact (the decode is integer): each
stage and each whole hybrid frame of rxt_cqo (4:2:0, CU chroma QP
offsets, SAO) and adv_erdpcm_dep (explicit RDPCM, dependent slices)
against libde265_tpu's reconstruct_frame_device on the same inputs; the
planners (dense-MC block arrays, deblocking metadata from the hybrid
frames' filter grids, intra border info), predict_core and the batched
TU residuals against the JAX functions or the numpy reference; the
routing of every
committed vector with refused frames, MD5-equal; the tile-column decoder
on adv_cqo_tiles; and the final device state of decoders that mix the
frame program, the hybrid path and the DPB insert against the JAX
DeviceStreamDecoder."""
import hashlib
import json
import os
import types

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
STAGE_VECTORS = ["rxt_cqo", "adv_erdpcm_dep", "rxt_cqo_scaling"]
# the committed vectors with frames that frame_compatible refuses ->
# (hybrid frames, numpy host frames): host = frame_uses_rext_tools
REFUSED = {"rxt_cqo": (4, 0), "adv_cqo_tiles": (4, 0),
           "rxt_cqo_10b": (3, 0), "rxt_erdpcm": (3, 0),
           "rxt_erdpcm_rot_tsctx": (3, 0), "adv_erdpcm_dep": (3, 0),
           "adv_ccp_tiles_444": (0, 3), "adv_rot_tsctx_wpp": (0, 1),
           "rxt_ccp_444": (0, 4), "rxt_ccp_cqo_444": (0, 3),
           "rxt_ccp_rot_444": (0, 3), "rxt_kitchen": (0, 4),
           "rxt_smooth_off": (0, 3)}
# rxt_cqo_scaling (tools/gen_torch_hybrid_scaling_stream.py): rxt_cqo's CU
# chroma QP offsets with SPS scaling lists and transform skip, made by the
# port's encoder: every frame hybrid, its residuals through the scaling-
# list batches of ops/transform.tu_residuals
SCALING_HYBRID = (4, 0)


def _data(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _plans(name):
    from libde265_tpu_torch.api import _parse
    return _parse(_data(name))


def _manifest(name):
    mf = "manifest_torch.json" if name == "rxt_cqo_scaling" else \
        {"adv": "manifest_adv.json",
         "rxt": "manifest_rext_tools.json"}[name.split("_")[0]]
    with open(os.path.join(DATA, mf)) as f:
        return json.load(f)[name]


def _t(planes):
    return [torch.as_tensor(np.asarray(p, np.int32)) for p in planes]


def _eq(got, want, what):
    for c, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.int32)
        assert g.shape == w.shape, (what, c)
        assert np.array_equal(g.numpy(), w), (what, c)


@pytest.fixture(scope="module", params=STAGE_VECTORS)
def jax_frames(request):
    """The JAX DeviceStreamDecoder over the port's plans of one vector,
    each stage of its hybrid path wrapped to keep its inputs and output:
    {frame id: {refs, mc, pre_intra, intra, pre_filter, final}} (numpy),
    with the plans (which the JAX side leaves with materialized
    TURecords)."""
    import libde265_tpu.device_decode as jdd
    import libde265_tpu.ops.filters_fused_jax as jff
    import libde265_tpu.ops.inter_dense_jax as jid
    import libde265_tpu.ops.intra_jax as jia
    from libde265_tpu.device_stream import DeviceStreamDecoder as JaxDec
    name = request.param
    plans = _plans(name)
    rec = {}

    def copies(planes):
        return [np.array(p) for p in planes]

    def mc(plan, planes, dpb, bitdepth=8):
        fids = sorted({pu.ref_dpb[l] for pu in plan.pus for l in range(2)
                       if pu.pred_flag[l]})
        rec[plan.frame_id]["refs"] = {f: copies(dpb.pics[f].planes)
                                      for f in fids}
        real["mc"](plan, planes, dpb, bitdepth)
        rec[plan.frame_id]["mc"] = copies(planes)

    def intra(plan, planes, bitdepth=8, strong=False):
        rec[plan.frame_id]["pre_intra"] = copies(planes)
        real["intra"](plan, planes, bitdepth, strong)
        rec[plan.frame_id]["intra"] = copies(planes)

    def filters(plan, planes):
        rec[plan.frame_id]["pre_filter"] = copies(planes)
        out = real["filters"](plan, planes)
        rec[plan.frame_id]["final"] = copies(out)
        return out

    def frame(plan, dpb_images=None, bitdepth=None):
        rec[plan.frame_id] = {"plan": plan, "refs": {}}
        return real["frame"](plan, dpb_images, bitdepth)

    real = {"mc": jid.motion_compensate_frame_dense,
            "intra": jia.intra_reconstruct_device,
            "filters": jff.apply_filters_fused,
            "frame": jdd.reconstruct_frame_device}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jid, "motion_compensate_frame_dense", mc)
        mp.setattr(jia, "intra_reconstruct_device", intra)
        mp.setattr(jff, "apply_filters_fused", filters)
        mp.setattr(jdd, "reconstruct_frame_device", frame)
        JaxDec(plans, plans[0].sps).decode_all()
    assert len(rec) == REFUSED.get(name, SCALING_HYBRID)[0]
    return name, plans, rec


def _dec(plan, refs):
    """A stand-in for the decoder that reconstruct_frame_device reads:
    DPB stacks holding `refs` at slots counted down from the last."""
    from libde265_tpu_torch.packing import REF_SLOTS
    H, W = plan.H, plan.W
    sps = plan.sps
    Hc, Wc = H // sps.SubHeightC, W // sps.SubWidthC
    dy = torch.zeros((REF_SLOTS, H, W), dtype=torch.int16)
    dcb = torch.zeros((REF_SLOTS, Hc, Wc), dtype=torch.int16)
    dcr = torch.zeros((REF_SLOTS, Hc, Wc), dtype=torch.int16)
    slot_of = {}
    for i, (fid, planes) in enumerate(sorted(refs.items())):
        s = REF_SLOTS - 1 - i
        for stack, p in zip((dy, dcb, dcr), planes):
            stack[s] = torch.as_tensor(np.asarray(p, np.int16))
        slot_of[fid] = s
    return types.SimpleNamespace(
        dy=dy, dcb=dcb, dcr=dcr, slot_of=slot_of, device=torch.device("cpu"),
        cfg=types.SimpleNamespace(bitdepth=sps.BitDepthY))


def _stage_io(r):
    """(input, output) planes of the residual stage as JAX ran it."""
    zero = [np.zeros_like(p) for p in r["final"]]
    out = r.get("pre_intra", r["pre_filter"])
    return r.get("mc", zero), out


def test_dense_mc_matches_jax(jax_frames):
    """Stage 1, per hybrid frame with prediction units: the port's dense
    MC from DPB stacks at their slots equals the JAX op's from its
    restacked host copies."""
    from libde265_tpu_torch.device_decode import dense_mc, new_planes
    _, _, rec = jax_frames
    n = 0
    for fid, r in rec.items():
        if "mc" not in r:
            continue
        plan = r["plan"]
        dec = _dec(plan, r["refs"])
        got = dense_mc(plan, dec, new_planes(plan, "cpu"),
                       plan.sps.BitDepthY)
        _eq(got, r["mc"], f"mc frame {fid}")
        n += 1
    assert n


def test_inter_residuals_match_jax(jax_frames):
    """Stage 2: the PCM paste and inter residuals (explicit RDPCM on the
    host branch) from the JAX stage's input."""
    from libde265_tpu_torch.device_decode import inter_residuals
    _, _, rec = jax_frames
    for fid, r in rec.items():
        plan = r["plan"]
        src, want = _stage_io(r)
        got = inter_residuals(plan, None, _t(src), plan.sps.BitDepthY)
        _eq(got, want, f"residual frame {fid}")


def test_intra_levels_match_jax(jax_frames):
    """Stage 3: the intra wavefront from the JAX stage's input, on every
    hybrid frame with intra TUs."""
    from libde265_tpu_torch.device_decode import intra_levels
    _, _, rec = jax_frames
    n = 0
    for fid, r in rec.items():
        if "intra" not in r:
            continue
        plan = r["plan"]
        got = intra_levels(plan, None, _t(r["pre_intra"]),
                           plan.sps.BitDepthY)
        _eq(got, r["intra"], f"intra frame {fid}")
        n += 1
    assert n


def test_loop_filters_match_jax(jax_frames):
    """Stage 4: deblocking through K6's plain version (the device
    planner and the plain passes), then SAO through K3's, from the JAX
    stage's input."""
    from libde265_tpu_torch.device_decode import loop_filters
    from libde265_tpu_torch.ops.kernels.deblock import deblock_frame
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    _, _, rec = jax_frames
    n3, n6 = sao_ctb.launches, deblock_frame.launches
    for fid, r in rec.items():
        plan = r["plan"]
        got = loop_filters(plan, None, _t(r["pre_filter"]),
                           plan.sps.BitDepthY)
        _eq(got, r["final"], f"filters frame {fid}")
    # CPU tensors: no launch
    assert (sao_ctb.launches, deblock_frame.launches) == (n3, n6)


def test_whole_frames_match_jax(jax_frames):
    """reconstruct_frame_device, every hybrid frame of the vector, from
    the same reference pictures: equal to the JAX frame."""
    from libde265_tpu_torch.device_decode import reconstruct_frame_device
    _, _, rec = jax_frames
    for fid, r in rec.items():
        plan = r["plan"]
        got = reconstruct_frame_device(plan, _dec(plan, r["refs"]))
        _eq(got, r["final"], f"frame {fid}")


def test_host_planners_match_jax(jax_frames):
    """The planners against the JAX functions on every hybrid frame: the
    dense-MC block arrays (same slot map), the deblocking metadata of
    both directions that plan_deblock_device derives from the frame's
    filter grids (against the JAX frame program's planner on the same
    grids), and the intra border info of every (plane, log2) class of
    intra TUs."""
    import jax.numpy as jnp
    from libde265_tpu.ops import filter_plan_jax as FJ
    from libde265_tpu.ops.inter_dense_jax import \
        build_block_arrays as jax_blocks
    from libde265_tpu.ops.intra_jax import host_border_info as jax_border
    from libde265_tpu.reconstruct import Availability
    from libde265_tpu_torch.device_plan import build_filter_grids, filter_cfg
    from libde265_tpu_torch.ops import filter_plan as FP
    from libde265_tpu_torch.ops.inter_dense import build_block_arrays
    from libde265_tpu_torch.ops.intra import host_border_info
    from libde265_tpu_torch.plan import MODE_INTRA
    _, _, rec = jax_frames
    for fid, r in rec.items():
        plan = r["plan"]
        bd = plan.sps.BitDepthY
        slots = {f: 7 - i for i, f in enumerate(sorted(r["refs"]))}
        if slots:
            for a, b in zip(build_block_arrays(plan, slots, bd),
                            jax_blocks(plan, slots, bd)):
                assert np.array_equal(a, b), fid
        g = build_filter_grids(plan)
        lm_p, cm_p = FP.plan_deblock_device(
            {k: torch.as_tensor(v) for k, v in g.items()}, filter_cfg(plan))
        lm_j, cm_j = FJ.plan_deblock_device(
            {k: jnp.asarray(v) for k, v in g.items()}, filter_cfg(plan))
        assert int(lm_p[0][0].count_nonzero()) > 0, fid   # edges filtered
        for a, b in zip(lm_p + cm_p, lm_j + cm_j):
            for x, y in zip(a, b):
                assert np.array_equal(x.numpy(), np.asarray(y)), fid
        avail = Availability(plan)
        classes = {}
        for tu in plan.tus:
            if tu.cidx >= 0 and tu.pred_mode == MODE_INTRA:
                classes.setdefault((tu.cidx, tu.log2), []).append(tu)
        for (cidx, log2), tus in classes.items():
            got = host_border_info(plan, [t.x for t in tus],
                                   [t.y for t in tus], cidx, log2)
            want = jax_border(plan, avail, tus, cidx, log2, bd)
            for a, b in zip(got, want):
                assert np.array_equal(a, b), (fid, cidx, log2)


@pytest.mark.parametrize("log2,luma,strong", [
    (2, True, False), (3, True, False), (4, True, False), (5, True, True),
    (5, True, False), (2, False, False), (3, False, False),
    (4, False, False)])
def test_predict_core_matches_jax(log2, luma, strong):
    """All 35 modes on seeded borders (smooth ones among them, so the
    strong filter's condition holds for some), against the JAX
    predict_core, with and without the [1,2,1] / strong smoothing."""
    import jax.numpy as jnp
    from libde265_tpu.ops.intra_jax import predict_core as jax_core
    from libde265_tpu_torch.ops.intra import predict_core
    n = 1 << log2
    rng = np.random.RandomState(log2 * 4 + luma * 2 + strong)
    N = 35 * 3
    ref = rng.randint(0, 1024, (N, 4 * n + 1)).astype(np.int32)
    ref[35:70] = (np.linspace(200, 260, 4 * n + 1)[None, :]
                  + rng.randint(0, 2, (35, 4 * n + 1))).astype(np.int32)
    ref[70:] = 512
    modes = np.tile(np.arange(35, dtype=np.int32), 3)
    for smooth in (False, True):
        want = np.asarray(jax_core(jnp.asarray(ref), jnp.asarray(modes),
                                   log2, luma, 10, strong, smooth))
        got = predict_core(torch.as_tensor(ref),
                           torch.as_tensor(modes.astype(np.int64)), log2,
                           luma, 10, strong, smooth)
        assert np.array_equal(got.numpy(), want), smooth


def _scaling_list(rng):
    """A coded scaling list of seeded entries in [1, 255]."""
    def m(k, n):
        return [list(rng.randint(1, 256, n)) for _ in range(k)]
    return types.SimpleNamespace(
        m4=m(6, 16), m8=m(6, 64), m16=m(6, 64), m32=m(2, 64),
        dc16=list(rng.randint(1, 256, 6)), dc32=list(rng.randint(1, 256, 2)))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("scaling", [False, True])
def test_tu_residuals_match_reference(log2, intra, scaling):
    """ops/transform.tu_residuals on a seeded TU table that mixes
    transformed, transform-skip and bypass TUs (explicit RDPCM on the
    inter ones) with a flat or scaling-list dequant, TU by TU against the
    numpy reference scale_and_inv_transform."""
    from libde265_tpu_torch.ops.transform import tu_residuals
    from libde265_tpu_torch.ops.transform_ref import (
        scale_and_inv_transform, scaling_matrix)
    from libde265_tpu_torch.plan import MODE_INTER, MODE_INTRA
    rng = np.random.RandomState(log2 * 4 + intra * 2 + scaling)
    n, K = 1 << log2, 24
    cidx = 0 if log2 in (2, 4) else 1
    sl = _scaling_list(rng)
    plan = types.SimpleNamespace(
        sps=types.SimpleNamespace(scaling_list_enable_flag=int(scaling),
                                  scaling_list=sl),
        pps=types.SimpleNamespace(pic_scaling_list_data_present_flag=0))
    coeffs = rng.randint(-300, 301, (K, n, n)).astype(np.int16)
    coeffs[rng.rand(K, n, n) < 0.6] = 0
    kind = np.arange(K) % 3                      # transform, skip, bypass
    rdpcm = np.where((kind > 0) & (not intra), rng.randint(0, 3, K), 0)
    meta = np.zeros((K + 1, 12), np.int32)       # row 0: another class
    meta[1:, 0] = cidx
    meta[1:, 3] = log2
    meta[1:, 5] = rng.randint(0, 46, K)
    meta[1:, 6] = kind == 1
    meta[1:, 7] = kind == 2
    meta[1:, 8] = MODE_INTRA if intra else MODE_INTER
    meta[1:, 9] = 7 + n * n * np.arange(K)
    meta[1:, 11] = rdpcm
    pool = np.concatenate([np.zeros(7, np.int16), coeffs.ravel()])
    rows = np.arange(1, K + 1)[::-1]             # any order of the rows
    got = tu_residuals(plan, meta, pool, rows, 10, "cpu")
    smat, sdc = scaling_matrix(sl, log2, cidx, intra) if scaling \
        else (None, None)
    for j, i in enumerate(rows - 1):
        want = scale_and_inv_transform(
            coeffs[i].astype(np.int32), int(meta[i + 1, 5]), log2,
            intra and cidx == 0 and log2 == 2, kind[i] == 1, kind[i] == 2,
            10, smat, sdc, rdpcm=int(rdpcm[i]))
        assert np.array_equal(got[j].numpy(), want), (j, kind[i], rdpcm[i])


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_frames_route_as_jax(name):
    """Every committed vector with frames the frame program refuses,
    through decode_stream_native on the CPU: MD5-equal, the frames that
    the JAX decode_plan gives the numpy reference (frame_uses_rext_tools)
    on the host path and the other refused frames on the hybrid path."""
    from libde265_tpu.frame_program import frame_uses_rext_tools as jax_rext
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.packing import (frame_compatible,
                                            frame_uses_rext_tools)
    m = _manifest(name)
    st = {}
    pics = decode_stream_native(_data(name), device="cpu", stats=st)
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i
    plans = _plans(name)
    refused = [p for p in plans if not frame_compatible(p)]
    rext = [frame_uses_rext_tools(p) for p in refused]
    assert rext == [jax_rext(p) for p in refused]
    want = (len(refused) - sum(rext), sum(rext))
    assert want == REFUSED[name]
    assert (st["n_hybrid_frames"], st["n_host_frames"]) == want


def test_scaling_list_frames_take_the_hybrid_path():
    """rxt_cqo_scaling through decode_stream_native on the CPU: scaling
    lists on, every frame on the hybrid path, none on the host, MD5-equal
    to its golden in manifest_torch.json."""
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.packing import frame_compatible
    name = "rxt_cqo_scaling"
    m = _manifest(name)
    plans = _plans(name)
    assert plans[0].sps.scaling_list_enable_flag
    assert not any(frame_compatible(p) for p in plans)
    st = {}
    pics = decode_stream_native(_data(name), device="cpu", stats=st)
    assert (len(pics), st["n_hybrid_frames"], st["n_host_frames"]) == \
        (m["frames"], *SCALING_HYBRID)
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i


def test_refused_frame_totals():
    """20 refused frames of the committed vectors take the hybrid path
    and 21 the numpy reference, as in the JAX DeviceStreamDecoder."""
    assert [sum(v[i] for v in REFUSED.values()) for i in (0, 1)] == [20, 21]


def test_tile_decoder_runs_hybrid_frames():
    """adv_cqo_tiles (two tile columns, CU chroma QP offsets in every
    frame) through the tile-column decoder: every frame on the hybrid
    path of devices[0], none as strips, MD5-equal."""
    from libde265_tpu_torch.api import decode_stream_native
    m = _manifest("adv_cqo_tiles")
    ncols = _plans("adv_cqo_tiles")[0].pps.num_tile_columns
    st = {}
    pics = decode_stream_native(_data("adv_cqo_tiles"), stats=st,
                                tile_devices=["cpu"] * ncols)
    assert (len(pics), st["n_hybrid_frames"], st["n_host_frames"],
            st["n_strip_frames"]) == (4, 4, 0, 0)
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        assert got == [m["md5"][i][k] for k in ("y", "u", "v")], i


@pytest.mark.parametrize("name", ["rxt_cqo_10b", "adv_erdpcm_dep"])
def test_final_state_matches_jax(name):
    """The port's decoder and the JAX one from the same plans: identical
    DPB stacks, tile tables (K1's plain version after each hybrid
    insert) and slot map. rxt_cqo_10b is hybrid in every frame at 10
    bits; adv_erdpcm_dep mixes a frame-program IDR with hybrid P frames
    that reference it."""
    from libde265_tpu.device_stream import DeviceStreamDecoder as JaxDec
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    plans = _plans(name)
    pd = DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    pd.decode_all()
    assert (pd.n_hybrid_frames, pd.n_host_frames) == (REFUSED[name][0], 0)
    jd = JaxDec(plans, plans[0].sps)
    jd.decode_all()
    assert pd.slot_of == jd.slot_of
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), pd.state(),
                          (jd.dy, jd.dcb, jd.dcr, jd.ty, jd.tc)):
        b = np.asarray(b)
        assert a.dtype == getattr(torch, b.dtype.name), what
        assert np.array_equal(a.numpy(), b), what
    for p in plans:
        got = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
               for a in pd.planes_of(p.frame_id)]
        want = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
                for a in jd.planes_of(p.frame_id)]
        assert got == want, p.frame_id


def test_pipeline_and_gops_keep_refusing_hybrid_frames():
    """The GOP decoder refuses a stream with refused frames with
    ValueError, as the JAX one asserts."""
    from libde265_tpu_torch.parallel.gop_shard import decode_gops
    plans = _plans("rxt_cqo")
    with pytest.raises(ValueError, match="not one the frame program"):
        decode_gops(_plans("rxt_cqo"), plans[0].sps, ["cpu"])


@pytest.mark.parametrize("name,sao", [("i_deblk_sao", True),
                                      ("p_deblk", False)])
def test_backend_reconstruct_frame_device_matches_jax(name, sao,
                                                      monkeypatch):
    """backend.reconstruct_frame_device (deblocking planned on the
    device, then SAO through K3's plain version) against the JAX
    package's backend.reconstruct_frame_device, from the same pre-filter
    planes of the vector's IDR (the numpy reference with its loop
    filters switched off); both equal the numpy reference's filtered
    frame."""
    from libde265_tpu import backend as JB
    from libde265_tpu_torch import backend as B
    from libde265_tpu_torch.reconstruct import reconstruct_frame
    plan = _plans(name)[0]
    shs = plan.slice_headers
    assert any(not sh.slice_deblocking_filter_disabled_flag for sh in shs)
    assert sao == any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                      for sh in shs)
    full = reconstruct_frame(plan)
    monkeypatch.setenv("DE265_DISABLE_DEBLOCK", "1")
    monkeypatch.setenv("DE265_DISABLE_SAO", "1")
    pre = reconstruct_frame(plan)
    assert any(not np.array_equal(a, b) for a, b in zip(pre, full))
    plan.planes = [p.copy() for p in pre]
    want = JB.reconstruct_frame_device(plan)
    plan.planes = [p.copy() for p in pre]
    got = B.reconstruct_frame_device(plan, device="cpu")
    assert plan.planes is got and got[0].dtype == torch.int32
    _eq(got, want, name)
    _eq(got, full, name)
