"""The port's encoder (libde265_tpu_torch.encoder and the host modules it
stands on: dpb, motion, bitstream.contextmodel / cabac / ctu, the SEI
writer) against the JAX package's (libde265_tpu.encoder).

Both encoders take the same seeded numpy frames and must write identical
bytes; the port then decodes each stream on the CPU (decode_stream_native
with device="cpu": the kernels' plain versions) and every frame must equal
the encoder's own reconstruction, MD5 for MD5. The encoder's parts (the
CABAC rate estimator, the context initialisation, the CABAC tables, the
merge / AMVP candidates of MotionDeriver) are held equal to the JAX ones
on seeded inputs.

Three configurations write streams whose decode differs from the
encoder's reconstruction in both packages (RECON_DIFFERS: cu_qp_delta,
two-PU B frames, per-slice filter flags). Both decoders agree there, and
the JAX encoder writes the same bytes, so the fault is the reference
encoder's (ROADMAP queue 3): their pictures are held equal to the JAX
decoder's instead.
"""
import hashlib
import random

import numpy as np
import pytest

BASE = dict(inter_mode="mixed", inter_residual=True)
FILTERS = dict(sao=True, disable_deblocking=False)

# name -> (width, height, frames, EncoderConfig kwargs)
CASES = {
    "default": (64, 64, 3, {}),
    "filters_tmvp": (64, 64, 3, dict(BASE, temporal_mvp=True, **FILTERS)),
    "ref2": (64, 64, 3, dict(inter_mode="mv", num_ref_l0=2)),
    "weighted_pred": (64, 64, 3, dict(inter_mode="mv", weighted_pred=True,
                                      luma_weight_delta=2, luma_offset=3)),
    "b_frames": (64, 64, 3, dict(BASE, b_frames=True, num_ref_l0=2,
                                 temporal_mvp=True)),
    "amp_2pu": (64, 64, 3, dict(inter_mode="2pu", amp=True, num_ref_l0=2)),
    "2pu_merge": (64, 64, 3, dict(inter_mode="2pu", two_pu_merge=True,
                                  num_ref_l0=2)),
    "b_2pu": (64, 64, 3, dict(inter_mode="2pu", b_frames=True)),
    "mv_residual": (64, 64, 3, dict(inter_mode="mv", inter_residual=True)),
    "gmv": (64, 64, 3, dict(inter_mode="gmv", global_mv=(-20, -12),
                            mv_jitter=3, inter_residual=True, num_ref_l0=2,
                            temporal_mvp=True)),
    "10bit": (64, 64, 3, dict(BASE, bit_depth=10, **FILTERS)),
    "422_intra": (64, 64, 2, dict(chroma_format=2, intra_period=1,
                                  **FILTERS)),
    "444_intra": (64, 64, 2, dict(chroma_format=3, intra_period=1,
                                  transform_skip=True)),
    "mono_intra": (64, 64, 2, dict(chroma_format=0, intra_period=1,
                                   sao=True)),
    "nxn_intra": (64, 64, 2, dict(cu_log2=3, nxn_intra=True,
                                  transform_skip=True, intra_period=1)),
    "tiles_wpp_dep_slices": (128, 64, 3, dict(
        BASE, tiles=(2, 2), wpp=True, num_slices=2, dependent_slices=True,
        **FILTERS)),
    "scaling_lists": (64, 64, 3, dict(BASE, scaling_lists=True)),
    "pcm_tq_bypass": (64, 64, 3, dict(BASE, pcm=True, tq_bypass=True,
                                      intra_period=2)),
    "rext_tskip_tools": (64, 64, 3, dict(
        BASE, transform_skip=True, tskip_rotation=True,
        transform_skip_context=True, implicit_rdpcm=True,
        explicit_rdpcm=True, tq_bypass=True, persistent_rice=True,
        chroma_qp_offset_list=((3, -3), (-5, 5)))),
    "ccp_444": (64, 64, 3, dict(BASE, chroma_format=3, cross_comp_pred=True,
                                transform_skip=True)),
    "cra_ltr": (64, 64, 4, dict(BASE, use_cra=True, intra_period=2,
                                use_ltr=True, num_ref_l0=2)),
    "temporal_layers": (64, 64, 4, dict(BASE, temporal_layers=True)),
    "hash_sei": (64, 64, 3, dict(BASE, write_hash_sei=True, **FILTERS)),
    "mixed_filter_slices": (96, 96, 3, dict(BASE, num_slices=2,
                                            mixed_filter_slices=True,
                                            **FILTERS)),
    "cu_qp_delta": (64, 64, 3, dict(BASE, cu_qp_delta=True, cu_log2=5)),
    "cip_qp_offsets": (64, 64, 3, dict(BASE, constrained_intra=True,
                                       cb_qp_offset=3, cr_qp_offset=-4)),
    "reflist_cabac_init": (64, 64, 4, dict(BASE, ref_list_reverse=True,
                                           num_ref_l0=3, cabac_init=True,
                                           b_frames=True, mvd_l1_zero=True)),
    "rdo": (64, 64, 2, dict(rdo=True, inter_mode="mv", inter_residual=True,
                            **FILTERS)),
    "bitrate": (64, 64, 3, dict(inter_mode="mv", inter_residual=True,
                                bitrate_kbps=150.0, fps=25.0)),
}
RECON_DIFFERS = {"b_2pu", "mixed_filter_slices", "cu_qp_delta"}


def make_frames(cf, W, H, bd, n, seed):
    """Seeded content: an 8x8-blocky random field with mild noise, panned
    by (1, 2) samples a frame, on every plane of the chroma format."""
    rng = np.random.RandomState(seed)
    mx = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16

    def plane(h, w):
        a = rng.randint(0, mx + 1, (h // 8 + 3, w // 8 + 3))
        a = np.kron(a, np.ones((8, 8), np.int64))
        return [np.clip(a[t:t + h, 2 * t:2 * t + w]
                        + rng.randint(-6, 7, (h, w)), 0, mx).astype(dt)
                for t in range(n)]

    sw = 2 if cf in (1, 2) else 1
    sh = 2 if cf == 1 else 1
    y = plane(H, W)
    if cf:
        u, v = plane(H // sh, W // sw), plane(H // sh, W // sw)
    else:
        u = v = [np.zeros((0, 0), dt)] * n
    return [[y[t], u[t], v[t]] for t in range(n)]


def _config(mod, name):
    W, H, n, kw = CASES[name]
    return mod.EncoderConfig(width=W, height=H, **kw), n


_STREAMS = {}


def _encoded(name):
    """(JAX bytes, port bytes, the port encoder's reconstruction of each
    frame), cached for the module."""
    if name not in _STREAMS:
        import libde265_tpu.encoder as J
        import libde265_tpu_torch.encoder as P
        cfg, n = _config(P, name)
        frames = make_frames(cfg.chroma_format, cfg.width, cfg.height,
                             cfg.bit_depth, n, seed=7)
        want = J.Encoder(_config(J, name)[0]).encode(frames)
        enc = P.Encoder(cfg)
        recon = []
        encode_frame = enc._encode_frame

        def keep_recon(*a):
            out = encode_frame(*a)
            recon.append([p.copy() for p in enc.recon])
            return out
        enc._encode_frame = keep_recon
        _STREAMS[name] = (want, enc.encode(frames), recon)
    return _STREAMS[name]


def _md5s(planes):
    return [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
            for p in planes]


@pytest.mark.parametrize("name", list(CASES))
def test_encoder_bytes_match_jax(name):
    want, got, recon = _encoded(name)
    assert len(recon) == CASES[name][2]
    assert got == want, (name, len(got), len(want))


@pytest.mark.parametrize("name", list(CASES))
def test_encoder_stream_decodes_to_recon(name):
    """The port decodes the port's stream on the CPU to the encoder's
    reconstruction (RECON_DIFFERS: to the JAX decoder's pictures)."""
    from libde265_tpu_torch.api import decode_stream_native
    _, data, recon = _encoded(name)
    st = {}
    pics = decode_stream_native(data, device="cpu", stats=st)
    assert len(pics) == len(recon)
    if name in RECON_DIFFERS:
        from libde265_tpu.api import decode_stream_native as jax_decode
        recon = [p.planes for p in jax_decode(data)]
    for i, (pic, rec) in enumerate(zip(pics, recon)):
        assert [p.dtype for p in pic.planes] == [p.dtype for p in rec], i
        assert _md5s(pic.planes) == _md5s(rec), (name, i)


def test_hash_sei_checks_pass_in_push_api():
    """The port's SEI writer: the push API checks every picture hash the
    port's encoder wrote, and all pass."""
    from libde265_tpu_torch import api
    _, data, recon = _encoded("hash_sei")
    dec = api.new_decoder(device="cpu")
    api.push_data(dec, data)
    api.flush_data(dec)
    while api.decode(dec):
        pass
    n = 0
    while api.get_next_picture(dec) is not None:
        n += 1
    assert (n, dec.hash_checks_passed) == (len(recon), len(recon))
    assert api.get_warning(dec) is None


def test_picture_hash_sei_matches_jax():
    from libde265_tpu.bitstream import sei as J
    from libde265_tpu_torch.bitstream import sei as P
    rng = np.random.RandomState(3)
    for bd, dt in ((8, np.uint8), (10, np.uint16)):
        planes = [rng.randint(0, 1 << bd, s).astype(dt)
                  for s in ((16, 24), (8, 12), (8, 12))]
        for ht in (P.HASH_MD5, P.HASH_CRC, P.HASH_CHECKSUM):
            assert P.write_picture_hash_sei(planes, ht, bd) == \
                J.write_picture_hash_sei(planes, ht, bd)


# ------------------------------------------------------------ the parts
def test_cabac_tables_match_jax():
    from libde265_tpu.bitstream import cabac as J
    from libde265_tpu_torch.bitstream import cabac as P
    assert P.RANGE_TAB_LPS == J.RANGE_TAB_LPS
    assert P.TRANS_IDX_LPS == J.TRANS_IDX_LPS


def test_ctu_helpers_match_jax():
    from libde265_tpu.bitstream import ctu as J
    from libde265_tpu_torch.bitstream import ctu as P
    assert P.CTX_IDX_MAP_4x4 == J.CTX_IDX_MAP_4x4
    assert P.MAP_CHROMA_422 == J.MAP_CHROMA_422
    for cat in (0, 1, 2, 3):
        assert [P.chroma_qp_from_luma(q, cat) for q in range(-12, 58)] == \
            [J.chroma_qp_from_luma(q, cat) for q in range(-12, 58)]
    for pm in range(8):
        for size in (8, 16, 32, 64):
            assert P.part_geometry(pm, size) == J.part_geometry(pm, size)
    assert [P.clip3(0, 9, v) for v in range(-3, 13)] == \
        [J.clip3(0, 9, v) for v in range(-3, 13)]


@pytest.mark.parametrize("init_type", [0, 1, 2])
def test_context_init_matches_jax(init_type):
    from libde265_tpu.bitstream import contextmodel as J
    from libde265_tpu_torch.bitstream import contextmodel as P
    for qp in range(-6, 58):
        a, b = P.ContextModelTable(), J.ContextModelTable()
        a.init_states(init_type, qp)
        b.init_states(init_type, qp)
        assert a.models == b.models and a.stat_coeff == b.stat_coeff, qp
    rng = np.random.RandomState(init_type)
    for iv in rng.randint(0, 256, 64):
        for qp in (0, 22, 37, 51):
            assert P.init_context(int(iv), qp) == J.init_context(int(iv), qp)


def _bins(seed, n=20000):
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        r = rng.randrange(10)
        if r < 7:
            ops.append(("bin", rng.randrange(8), int(rng.random() < 0.8)))
        elif r < 9:
            ops.append(("bypass", rng.getrandbits(1)))
        else:
            ops.append(("bits", rng.getrandbits(5), 5))
    return ops


def _run(coder, ctxs, ops):
    for op in ops:
        if op[0] == "bin":
            j, mps = op[1], op[2]
            coder.encode_bin(ctxs[j], ctxs[j][1] if mps else 1 - ctxs[j][1])
        elif op[0] == "bypass":
            coder.encode_bypass(op[1])
        else:
            coder.encode_bypass_bits(op[1], op[2])


def test_rate_estimator_matches_jax():
    """CabacEstimator / CabacEstimatorConstant: the same bit counts and
    context states as the JAX ones on a seeded bin sequence."""
    from libde265_tpu.encoder import rate_estim as J
    from libde265_tpu_torch.encoder import rate_estim as P
    assert P.ENTROPY_TABLE == J.ENTROPY_TABLE
    ops = _bins(5)
    rng = random.Random(9)
    init = [[rng.randrange(60), rng.getrandbits(1)] for _ in range(8)]
    for cls in ("CabacEstimator", "CabacEstimatorConstant"):
        a, b = getattr(P, cls)(), getattr(J, cls)()
        ca, cb = [c[:] for c in init], [c[:] for c in init]
        _run(a, ca, ops)
        _run(b, cb, ops)
        assert a.bits == b.bits and ca == cb, cls


def test_cabac_encoder_matches_jax_and_round_trips():
    """The port's CabacEncoder writes the JAX one's bytes, and the port's
    CabacDecoder reads the bins back."""
    from libde265_tpu.encoder.cabac_enc import CabacEncoder as JE
    from libde265_tpu_torch.bitstream.cabac import CabacDecoder
    from libde265_tpu_torch.encoder.cabac_enc import CabacEncoder as PE
    ops = _bins(11, 5000)
    rng = random.Random(4)
    init = [[rng.randrange(60), rng.getrandbits(1)] for _ in range(8)]
    outs = []
    for cls in (PE, JE):
        e, ctxs = cls(), [c[:] for c in init]
        _run(e, ctxs, ops)
        e.encode_terminate(1)
        outs.append(e.data())
    assert outs[0] == outs[1]
    d, ctxs = CabacDecoder(outs[0]), [c[:] for c in init]
    e_ctxs = [c[:] for c in init]
    for op in ops:
        if op[0] == "bin":
            j = op[1]
            want = e_ctxs[j][1] if op[2] else 1 - e_ctxs[j][1]
            _run(PE(), e_ctxs, [op])
            assert d.decode_bin(ctxs[j]) == want
        elif op[0] == "bypass":
            assert d.decode_bypass() == op[1]
        else:
            assert d.decode_bypass_bits(op[2]) == op[1]
    assert d.decode_terminate() == 1


def test_rd_lambda_and_rate_controller_match_jax():
    from libde265_tpu.encoder import ratectrl as JR, rdo as JD
    from libde265_tpu_torch.encoder import ratectrl as PR, rdo as PD
    for qp in range(0, 52):
        for st in (0, 1, 2):
            assert PD.rd_lambda(qp, st) == JD.rd_lambda(qp, st)
    a, b = PR.RateController(300.0, 25.0, 30, 6), \
        JR.RateController(300.0, 25.0, 30, 6)
    rng = np.random.RandomState(2)
    for i in range(40):
        intra = i % 6 == 0
        assert a.qp_for_frame(intra) == b.qp_for_frame(intra)
        bits = int(rng.randint(2000, 60000))
        a.update(bits, intra)
        b.update(bits, intra)


def test_mv_scaling_matches_jax():
    from libde265_tpu import motion as J
    from libde265_tpu_torch import motion as P
    rng = np.random.RandomState(8)
    for _ in range(2000):
        mv = tuple(int(v) for v in rng.randint(-40000, 40000, 2))
        tb, td = (int(v) for v in rng.randint(-128, 128, 2))
        if td == 0:
            continue
        assert P.scale_mv(mv, tb, td) == J.scale_mv(mv, tb, td)
        assert P.mv_wrap(mv[0] * 3) == J.mv_wrap(mv[0] * 3)


def _record_candidates(monkeypatch, mod, log):
    """Log every merge-candidate list and AMVP predictor pair that mod's
    MotionDeriver derives, as plain tuples."""
    D = mod.MotionDeriver

    def cand(c):
        return (tuple(c.pf), tuple(map(tuple, c.mv)), tuple(c.ref))

    def merge(self, *a, **k):
        out = D._merge_candidates.__wrapped__(self, *a, **k)
        log.append(("merge", a[1:], [cand(c) for c in out]))
        return out

    def amvp(self, *a, **k):
        out = D._amvp_predictors.__wrapped__(self, *a, **k)
        log.append(("amvp", a[1:7], [tuple(m) for m in out]))
        return out
    merge.__wrapped__ = D._merge_candidates
    amvp.__wrapped__ = D._amvp_predictors
    monkeypatch.setattr(D, "_merge_candidates", merge)
    monkeypatch.setattr(D, "_amvp_predictors", amvp)


@pytest.mark.parametrize("name", ["b_frames", "2pu_merge", "gmv"])
def test_motion_candidates_match_jax(name, monkeypatch):
    """MotionDeriver: every merge list (spatial, temporal, combined
    bi-predictive, zero candidates) and AMVP pair that the encoder asks
    for while encoding the seeded frames equals the JAX one."""
    import libde265_tpu.encoder as J
    import libde265_tpu.motion as JM
    import libde265_tpu_torch.encoder as P
    import libde265_tpu_torch.motion as PM
    logs = {}
    for enc, mm, key in ((P, PM, "port"), (J, JM, "jax")):
        logs[key] = []
        _record_candidates(monkeypatch, mm, logs[key])
        cfg, n = _config(enc, name)
        frames = make_frames(cfg.chroma_format, cfg.width, cfg.height,
                             cfg.bit_depth, n, seed=7)
        enc.Encoder(cfg).encode(frames)
    assert logs["port"] == logs["jax"]
    kinds = {e[0] for e in logs["port"]}
    assert kinds == ({"amvp"} if name == "gmv" else {"amvp", "merge"})


def _dpb_trace(mod, seed):
    """Drive mod.DPB through a seeded sequence of inserts, reference
    marking, reorder bumping and lookups; return what it reports."""
    rng = np.random.RandomState(seed)
    d, out = mod.DPB(size=8), []
    for poc in range(40):
        if not d.has_free():
            d.drop_oldest_reference()
        i = d.new_picture(poc)
        d.insert_reorder(i)
        for p in d.pics:
            r = rng.rand()
            if p.state == mod.SHORT_TERM and r < 0.25:
                p.state = mod.UNUSED
            elif p.state == mod.SHORT_TERM and r < 0.3:
                p.state = mod.LONG_TERM
        while d.num_pictures_in_reorder() > rng.randint(0, 4):
            d.output_next()
        q = d.pop_output() if rng.rand() < 0.8 else d.peek_output()
        out.append((i, d.free_slot(), q and q.poc,
                    d.index_with_poc(int(rng.randint(0, poc + 1))),
                    d.index_with_poc_lsb(int(rng.randint(0, 16)), 16),
                    [(p.poc, p.state, p.needed_for_output) for p in d.pics]))
        if poc % 13 == 12:
            d.clear_references()
    d.flush_reorder()
    out.append([p.poc for p in d.output_queue])
    d.reset()
    out.append([(p.poc, p.state) for p in d.pics])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_dpb_matches_jax(seed):
    """DPB: the same slots, states, lookups and output order as the JAX
    one under the same seeded sequence."""
    from libde265_tpu import dpb as J
    from libde265_tpu_torch import dpb as P
    assert _dpb_trace(P, seed) == _dpb_trace(J, seed)
