"""The 4:2:0 residual tools in the port (transform-skip, transquant
bypass, PCM, scaling lists) against the JAX package on the same inputs:
the batched scaling-list dequant and transforms and the per-TU kind
select (libde265_tpu/ops/transform_jax.py), one P frame of each tool's
vector through both frame programs, and the intra residual classes of
intra_fused._residuals. All exact."""
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")


def _inputs(rng, log2, N, cmax):
    n = 1 << log2
    c = rng.randint(-cmax, cmax + 1, (N, n, n)).astype(np.int32)
    qp = rng.randint(0, 52, N).astype(np.int32)
    smat = rng.randint(1, 256, (N, n, n)).astype(np.int32)
    return c, qp, smat


def _jax_kinds(res, c, qp, smat, kd, log2):
    """The JAX frame program's per-TU select (frame_program.py:1106-1120)
    from transform_jax's functions, with the numpy reference's
    transform-skip shift (5 + log2) above 4x4, where the JAX function
    keeps 4x4's (ROADMAP queue 3)."""
    import jax.numpy as jnp
    from libde265_tpu.ops import transform_jax as TJ
    from libde265_tpu.ops.transform_ref import transform_skip_residual
    d = TJ.dequant_batch(c, qp, log2, 8) if smat is None \
        else TJ.dequant_batch_sl(c, qp, smat, log2, 8)
    k = jnp.asarray(kd)[:, None, None]
    ts = TJ.transform_skip_batch(d, log2, 8) if log2 == 2 else \
        jnp.asarray(np.stack([transform_skip_residual(b, log2, 8)
                              for b in np.asarray(d)]))
    res = jnp.where(k == 1, ts, res)
    return np.asarray(jnp.where(k == 2, c, res))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_residual_kinds_transform_skip_matches_reference(log2):
    """residual_kinds on transform-skip and bypass TUs, flat and
    scaling-list dequant, against the numpy spec oracle TU by TU
    (transform_ref.dequant, then transform_skip_residual: the 5 + log2
    shift at every size)."""
    from libde265_tpu.ops.transform_ref import (dequant,
                                                transform_skip_residual)
    from libde265_tpu_torch.ops import transform as T
    rng = np.random.RandomState(60 + log2)
    c, qp, smat = _inputs(rng, log2, 16, 3000)
    kd = rng.randint(1, 3, 16).astype(np.int8)
    tc, tq, ts = (torch.from_numpy(a) for a in (c, qp, smat))
    res = torch.zeros_like(tc)
    for sm in (None, smat[5]):
        got = T.residual_kinds(res, tc, tq, None if sm is None
                               else torch.from_numpy(sm),
                               torch.from_numpy(kd), 3, log2).numpy()
        for i in range(16):
            want = c[i] if kd[i] == 2 else transform_skip_residual(
                dequant(c[i], int(qp[i]), log2, 8, scaling_matrix=sm),
                log2, 8)
            assert np.array_equal(got[i], want), (i, kd[i])


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_scaling_list_transforms_match_jax(log2):
    """dequant_batch_sl (per-TU and shared matrices), residual_batch_sl
    and the kind select against transform_jax, on seeded levels small
    enough that the JAX dequant (int32 under x64 off) does not wrap:
    |400 * 255 * 72 << 8| < 2^31."""
    import jax.numpy as jnp
    from libde265_tpu.ops import transform_jax as TJ
    from libde265_tpu_torch.ops import transform as T
    rng = np.random.RandomState(40 + log2)
    c, qp, smat = _inputs(rng, log2, 24, 400)
    tc, tq, ts = (torch.from_numpy(a) for a in (c, qp, smat))
    jc, jq, js = (jnp.asarray(a) for a in (c, qp, smat))
    is_dst = log2 == 2
    for sm_t, sm_j in ((ts, js), (ts[3], js[3])):
        got = T.dequant_batch_sl(tc, tq, sm_t, log2)
        assert np.array_equal(got.numpy(), np.asarray(
            TJ.dequant_batch_sl(jc, jq, sm_j, log2, 8)))
        got = T.residual_batch_sl(tc, tq, sm_t, log2, is_dst)
        assert np.array_equal(got.numpy(), np.asarray(
            TJ.residual_batch_sl(jc, jq, sm_j, log2, is_dst, 8)))
    kd = rng.randint(0, 3, 24).astype(np.int8)
    for sm_t, sm_j in ((None, None), (ts, js)):
        res = T.residual_batch(tc, tq, log2, is_dst) if sm_t is None \
            else T.residual_batch_sl(tc, tq, sm_t, log2, is_dst)
        jres = TJ.residual_batch(jc, jq, log2, is_dst, 8) if sm_j is None \
            else TJ.residual_batch_sl(jc, jq, sm_j, log2, is_dst, 8)
        assert np.array_equal(res.numpy(), np.asarray(jres))
        got = T.residual_kinds(res, tc, tq, sm_t, torch.from_numpy(kd), 3,
                               log2)
        assert np.array_equal(got.numpy(),
                              _jax_kinds(jres, jc, jq, sm_j, kd, log2))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_scaling_list_dequant_full_range(log2):
    """Over the whole 16-bit level range (where the JAX dequant would
    wrap in int32), dequant_batch_sl against the numpy spec oracle
    ops/transform_ref.dequant, TU by TU."""
    from libde265_tpu.ops.transform_ref import dequant
    from libde265_tpu_torch.ops import transform as T
    rng = np.random.RandomState(50 + log2)
    c, qp, smat = _inputs(rng, log2, 12, 32767)
    got = T.dequant_batch_sl(*(torch.from_numpy(a) for a in (c, qp, smat)),
                             log2).numpy()
    for i in range(c.shape[0]):
        assert np.array_equal(got[i], dequant(c[i], int(qp[i]), log2, 8,
                                              scaling_matrix=smat[i])), i


@pytest.mark.parametrize("name", ["p_scaling", "p_tskip", "p_tqbypass",
                                  "p_pcm"])
def test_frame_program_tools_match_jax(name, monkeypatch):
    """The first P frame of each tool's vector (scaling lists;
    transform-skip intra TUs; transquant-bypass inter and intra TUs; a
    PCM block) through both frame programs from the same seeded DPB
    state and packed plan, intra stage included (the JAX band scan in
    interpret mode): identical DPB stacks and tile tables."""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    import jax.numpy as jnp
    from libde265_tpu import frame_program as J
    from libde265_tpu_torch import frame_program as F
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.convert import plan_from_numpy, state_from_numpy
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = _parse(f.read())
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    plan = plans[1]                       # refers to plans[0] only
    assert P.frame_has_intra(plan) and P.frame_has_mc(plan)
    assert cp.scaling or cp.pcm or any(cp.res_kinds) \
        or any(e[5] for e in cp.intra)
    rng = np.random.RandomState(7)
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


@pytest.mark.parametrize("name", ["i_tskip_nxn", "adv_ltr_tsa_scaling"])
def test_intra_residuals_match_jax(name, monkeypatch):
    """intra_fused._residuals of the IDR (transform-skip 4x4 TUs; scaling
    lists with the per-row Cb/Cr matrix select) against the JAX
    package's on the same packed tensors."""
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")
    import jax.numpy as jnp
    from libde265_tpu import frame_program as J
    from libde265_tpu import intra_fused as JI
    from libde265_tpu_torch import intra_fused as I
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.convert import plan_from_numpy
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = _parse(f.read())
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    assert cp.scaling or any(e[5] for e in cp.intra)
    t = J.pack_frame(plans[0], cj, {}, real_slots=True)
    want = JI._residuals({k: jnp.asarray(v) for k, v in t.items()}, cj)
    got = I._residuals(plan_from_numpy(t, "cpu"), cp)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
