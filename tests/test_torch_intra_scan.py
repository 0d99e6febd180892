"""The port's intra stage (libde265_tpu_torch/intra_fused.intra_stage_scan,
K4's plain version on CPU) against the JAX package's intra_stage_scan
(its Pallas band-scan kernel in interpret mode, routed as
tests/test_intra_scan.py routes it) on every intra frame of the vectors,
fed identical seeded pre-intra planes: exact equality."""
import dataclasses
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
CASES = [("intra_64x64_q27", False), ("intra_104x72_q26", False),
         ("i_deblk_sao", False), ("p_cip", False), ("p_cif_mixed", False),
         ("i_deblk_sao", True),
         # 10 bits: the mid grey and strong-smoothing threshold follow it
         ("adv_cra_scaling_10b_amp", False), ("p_10bit", False)]


@pytest.fixture
def force_scan(monkeypatch):
    monkeypatch.setenv("DE265_INTRA_SCAN", "force")


def _plans(name):
    from libde265_tpu_torch.api import _parse
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return _parse(f.read())


def _punch_holes(t, rng):
    """Clear one interior available border sample in a third of the
    rows of every packed availability array (iok_*), in place; returns
    the number of rows punched."""
    n = 0
    for k in [k for k in t if k.startswith("iok_")]:
        bits = np.unpackbits(t[k], axis=1)
        for r in range(bits.shape[0]):
            ones = np.flatnonzero(bits[r])
            if ones.size >= 3 and rng.rand() < 0.33:
                bits[r, ones[rng.randint(1, ones.size - 1)]] = 0
                n += 1
        t[k] = np.packbits(bits, axis=1)
    return n


@pytest.mark.parametrize("name,holes", CASES)
def test_intra_stage_scan_matches_jax(name, holes, force_scan):
    """holes: availability holes punched into the packed plans, with the
    JAX kernel compiled for its masked-fill branch (intra_scan[2] False)
    and the port taking its fill path."""
    import jax
    import jax.numpy as jnp
    from libde265_tpu import frame_program as J
    from libde265_tpu.intra_fused import intra_stage_scan as jax_scan
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.intra_fused import intra_stage_scan
    plans = _plans(name)
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    assert cj.intra_scan and cp.intra_scan == cj.intra_scan
    if holes:
        cj = dataclasses.replace(cj, intra_scan=cj.intra_scan[:2] + (False,))
        cp = dataclasses.replace(cp, intra_scan=cp.intra_scan[:2] + (False,))
    fid_slot = {p.frame_id: i % P.REF_SLOTS for i, p in enumerate(plans)}
    rng = np.random.RandomState(len(name))
    scan = jax.jit(jax_scan, static_argnums=4)
    n = 0
    for plan in plans:
        if not (P.frame_compatible(plan) and P.frame_has_intra(plan)):
            continue
        mc = P.frame_has_mc(plan)
        vj = cj if mc else dataclasses.replace(cj, skip_mc=True)
        vp = cp if mc else dataclasses.replace(cp, skip_mc=True)
        tj = J.pack_frame(plan, vj, fid_slot, real_slots=True)
        if holes:
            assert _punch_holes(tj, rng) > 0
        tp = plan_from_numpy(tj, "cpu")
        H, W = cp.H, cp.W
        planes = [rng.randint(0, 1 << cp.bitdepth, s).astype(np.int32)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
        want = scan(*(jnp.asarray(p) for p in planes),
                    {k: jnp.asarray(v) for k, v in tj.items()}, vj)
        got = intra_stage_scan(*(torch.as_tensor(p) for p in planes), tp, vp)
        for ci, (g, w) in enumerate(zip(got, want)):
            g, w = g.numpy(), np.asarray(w)
            if not np.array_equal(g, w):
                bad = np.argwhere(g != w)
                raise AssertionError(
                    f"{name} frame {plan.frame_id} plane {ci}: {len(bad)} "
                    f"mismatches, first at {bad[0]}")
        n += 1
    assert n > 0


def _fill_reference(raw, okm, bitdepth):
    """numpy transcription of the substitution of the JAX fused intra
    path (libde265_tpu/intra_fused.py:561-570): forward fill from the
    last available sample, leading gap from the first available one,
    nothing available -> mid grey."""
    L = raw.shape[1]
    pos = np.arange(L)[None, :]
    idxv = np.where(okm, pos, -1)
    ffill = np.maximum.accumulate(idxv, axis=1)
    anyok = okm.any(axis=1)
    first = np.argmax(okm, axis=1)
    src = np.where(ffill >= 0, ffill, first[:, None])
    ref = np.take_along_axis(raw, src, axis=1)
    return np.where(anyok[:, None], ref, 1 << (bitdepth - 1))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_substitution_with_holes(log2):
    """The port's reference-sample substitution (span clamp, or the fill
    when the availability run has holes) on seeded availability rows,
    against the numpy transcription of the JAX fill. None of the test
    vectors has holes (their intra_scan[2] is True), so rows are made."""
    from libde265_tpu_torch.intra_fused import avail_spans
    from libde265_tpu_torch.ops.kernels.intra_scan import _subst_index
    rng = np.random.RandomState(40 + log2)
    L = 4 * (1 << log2) + 1
    R = 400
    okm = np.zeros((R, L), bool)
    for r in range(R):
        kind = r % 4
        if kind == 1:                       # one contiguous run
            a = rng.randint(0, L)
            okm[r, a:rng.randint(a, L) + 1] = True
        elif kind >= 2:                     # scattered, with holes
            okm[r] = rng.rand(L) < (0.3 if kind == 2 else 0.8)
    raw = rng.randint(0, 256, (R, L))
    want = _fill_reference(raw, okm, 8)
    avail = np.zeros((R, 256), np.int32)
    avail[:, :L] = okm
    spans = avail_spans(torch.as_tensor(avail)).numpy()
    nh = 0
    for r in range(R):
        nh += (int(spans[r]) >> 18) & 1
        src = _subst_index(L, int(spans[r]), avail[r])
        got = np.full(L, 128) if src is None else raw[r, src]
        assert np.array_equal(got, want[r]), (r, okm[r].astype(int))
    assert nh > R // 3


# ---- the wavefront's waits (K4 runs one thread block per CTB-row band)
WAVE_CASES = ["intra_104x72_q26", "p_cif_mixed", "p_tiles3r_mv",
              "p_tiles8nu_mv"]


def _waits_reference(recs, K, BH, reach=1):
    """Brute-force transcription of the waits: slot t of band b > 0 needs
    1 + the largest position p of a valid slot of band b-1 whose CTB
    column is at most t's column + reach; 0 otherwise."""
    r = np.asarray(recs, np.int64)
    valid = ((r >> 27) & 1) != 0
    col = (r & 0x1FFF) // BH
    need = np.zeros(r.size, np.int64)
    for t in range(K, r.size):
        if not valid[t]:
            continue
        b = t // K
        ps = [p for p in range(K) if valid[(b - 1) * K + p]
              and col[(b - 1) * K + p] <= col[t] + reach]
        need[t] = 1 + max(ps) if ps else 0
    return need


def _steps_reference(recs, K, need):
    """Critical path in TU steps by the recurrence, slot by slot."""
    r = np.asarray(recs, np.int64).reshape(-1, K)
    nd = np.asarray(need, np.int64).reshape(-1, K)
    above, steps = None, 0
    for b in range(r.shape[0]):
        f, cur = np.zeros(K, np.int64), 0
        for p in range(K):
            if (r[b, p] >> 27) & 1:
                cur = max(cur, above[nd[b, p] - 1] if nd[b, p] else 0) + 1
            f[p] = cur
        above, steps = f, max(steps, cur)
    return steps


def _eager_order(recs, K, need):
    """The most eager wavefront schedule: repeatedly run the next slot of
    the highest band whose wait is met (done[b-1] >= need[t]); padding
    slots run without waiting. Returns the slot order."""
    r = np.asarray(recs, np.int64)
    nd = np.asarray(need, np.int64)
    NB = r.size // K
    nxt = [b * K for b in range(NB)]
    done = [0] * NB
    order = []
    while len(order) < r.size:
        for b in reversed(range(NB)):
            t = nxt[b]
            if t < (b + 1) * K and (not (r[t] >> 27) & 1 or b == 0
                                    or done[b - 1] >= nd[t]):
                break
        else:
            raise AssertionError("wavefront deadlock")
        order.append(t)
        done[b] = t - b * K + 1
        nxt[b] += 1
    return order


def _scan_frames(name, cp=None):
    """(plan, frame cfg, packed CPU tensors) of every intra frame."""
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.convert import plan_from_numpy
    plans = _plans(name)
    cp = cp or P.stream_cfg(plans, plans[0].sps)
    fid_slot = {p.frame_id: i % P.REF_SLOTS for i, p in enumerate(plans)}
    for plan in plans:
        if not (P.frame_compatible(plan) and P.frame_has_intra(plan)):
            continue
        v = cp if P.frame_has_mc(plan) else dataclasses.replace(
            cp, skip_mc=True)
        yield plan, v, plan_from_numpy(P.pack_frame(plan, v, fid_slot), "cpu")


@pytest.mark.parametrize("name", WAVE_CASES + ["shuffled"])
def test_band_waits_match_definition(name, force_scan):
    """band_waits against the brute-force definition on every intra
    frame's plane groups, and on made-up records whose slots are in no
    column order within a band (with padding between them); the
    critical path against its slot-by-slot recurrence."""
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels.intra_scan import (band_waits,
                                                           pack_rec)
    from libde265_tpu_torch.profile_frames import wavefront_steps
    if name == "shuffled":
        rng = np.random.RandomState(7)
        K, BH, NB = 48, 16, 5
        x = rng.randint(0, 200, NB * K)
        valid = (rng.rand(NB * K) < 0.8).astype(np.int64)
        recs = torch.as_tensor(pack_rec(x, 0, 0, 1, valid, 0),
                               dtype=torch.int32)
        groups = [dict(recs=recs, K=K, BH=BH)]
    else:
        groups = [kw for _, v, t in _scan_frames(name)
                  for _, kw in scan_groups(t, v)]
    for kw in groups:
        need = band_waits(kw["recs"], kw["K"], kw["BH"])
        assert need.dtype == torch.int32
        want = _waits_reference(kw["recs"].numpy(), kw["K"], kw["BH"])
        assert np.array_equal(need.numpy(), want)
        steps, ntu = wavefront_steps(kw["recs"], kw["K"], need)
        assert steps == _steps_reference(kw["recs"].numpy(), kw["K"], want)
        assert ntu == int(((kw["recs"] >> 27) & 1).sum()) and steps <= ntu


@pytest.mark.parametrize("name,holes", [(n, False) for n in WAVE_CASES]
                         + [("intra_104x72_q26", True)])
def test_eager_wavefront_matches_serial_and_jax(name, holes, force_scan):
    """K4's plain version run in the most eager schedule the waits allow
    gives the planes of the serial slot order and of the JAX
    intra_stage_scan (Pallas in interpret mode), exactly; with holes the
    fill path reads raw lanes that the eager order has not finished and
    must discard them."""
    import jax
    import jax.numpy as jnp
    from libde265_tpu import frame_program as J
    from libde265_tpu.intra_fused import intra_stage_scan as jax_scan
    from libde265_tpu_torch import packing as P
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels.intra_scan import (band_waits,
                                                           intra_scan_plain)
    plans = _plans(name)
    cj = J.stream_cfg(plans, plans[0].sps)
    cp = P.stream_cfg(plans, plans[0].sps)
    if holes:
        cj = dataclasses.replace(cj, intra_scan=cj.intra_scan[:2] + (False,))
        cp = dataclasses.replace(cp, intra_scan=cp.intra_scan[:2] + (False,))
    fid_slot = {p.frame_id: i % P.REF_SLOTS for i, p in enumerate(plans)}
    rng = np.random.RandomState(len(name) + holes)
    scan = jax.jit(jax_scan, static_argnums=4)
    n = 0
    for plan in plans:
        if not (P.frame_compatible(plan) and P.frame_has_intra(plan)):
            continue
        mc = P.frame_has_mc(plan)
        vj = cj if mc else dataclasses.replace(cj, skip_mc=True)
        vp = cp if mc else dataclasses.replace(cp, skip_mc=True)
        tj = J.pack_frame(plan, vj, fid_slot, real_slots=True)
        if holes:
            assert _punch_holes(tj, rng) > 0
        H, W = cp.H, cp.W
        planes = [rng.randint(0, 1 << cp.bitdepth, s).astype(np.int32)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
        want = scan(*(jnp.asarray(p) for p in planes),
                    {k: jnp.asarray(v) for k, v in tj.items()}, vj)
        serial = [torch.as_tensor(p) for p in planes]
        eager = [torch.as_tensor(p.copy()) for p in planes]
        for idx, kw in scan_groups(plan_from_numpy(tj, "cpu"), vp):
            intra_scan_plain([serial[i] for i in idx], **kw)
            order = _eager_order(kw["recs"].numpy(), kw["K"],
                                 band_waits(kw["recs"], kw["K"], kw["BH"]))
            intra_scan_plain([eager[i] for i in idx], **kw, order=order)
        for ci, w in enumerate(want):
            w = np.asarray(w)
            assert np.array_equal(serial[ci].numpy(), w), (plan.frame_id, ci)
            assert np.array_equal(eager[ci].numpy(), w), (plan.frame_id, ci)
        n += 1
    assert n > 0


def test_eager_wavefront_negative_control(force_scan):
    """Waits loosened to the TU's own CTB column (no above-right CTB) let
    the eager schedule read samples the band above has not written yet:
    its planes differ from the serial run's, so the test above can
    fail."""
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan_plain
    rng = np.random.RandomState(5)
    differ = []
    for name in WAVE_CASES[:2]:
        for plan, v, t in _scan_frames(name):
            for idx, kw in scan_groups(t, v):
                dims = [(v.H, v.W)] + [(v.H // 2, v.W // 2)] * 2
                planes = [torch.as_tensor(rng.randint(0, 256, dims[i]),
                                          dtype=torch.int32) for i in idx]
                serial = [p.clone() for p in planes]
                intra_scan_plain(serial, **kw)
                loose = _waits_reference(kw["recs"].numpy(), kw["K"],
                                         kw["BH"], reach=0)
                order = _eager_order(kw["recs"].numpy(), kw["K"], loose)
                intra_scan_plain(planes, **kw, order=order)
                differ.append(not all(torch.equal(a, b)
                                      for a, b in zip(planes, serial)))
    assert any(differ), differ
