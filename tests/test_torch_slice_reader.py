"""The port's Python front end (libde265_tpu_torch.bitstream.ctu.SliceReader
under decoder.PictureDecoder) against the JAX package's
(libde265_tpu.bitstream.ctu.SliceReader under libde265_tpu.decoder.Decoder),
plan for plan: every 4x4 and CTB grid, the SAO arrays, the slice headers'
count and the TU / PU records, exact. Reconstruction is stubbed on both
sides (grey planes): the plans depend on the DPB's metadata, not on its
pixels.

Then the bridge (device_stream.bridge_plan) against the native front end's
plans of the same streams: its tu_table / pu_table rows (PU_FID mapped
from the per-picture frame ids to the native ones) and every grid."""
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")

VECTORS = ["intra_64x64_q27", "p_mixed", "p_depslices", "p_slices2wpp",
           "p_wppx", "p_tiles22", "p_ltr", "p_cra", "p_pcm", "p_tqbypass",
           "p_scaling", "p_sdh", "b_mixed", "p_wp", "p_10bit",
           "rext_422_104x72", "rext_444_104x72", "rext_mono_104x72",
           "rxt_ccp_444", "rxt_erdpcm", "rxt_cqo"]

GRIDS = ("pred_mode", "skip_flag", "intra_mode_y", "intra_mode_c",
         "intra_cmode4", "ct_depth", "log2_cb_size", "qp_y", "tq_bypass",
         "pcm_flag", "cbf_luma", "tu_boundary", "pb_boundary",
         "cb_boundary", "mv", "ref_idx", "pred_flag", "ref_poc", "ref_lt",
         "slice_addr_rs", "ctb_slice_seg", "cmv", "cref_idx", "cpred_flag",
         "cref_poc", "cis_long_term", "cintra")
NATIVE_GRIDS = GRIDS[:4] + GRIDS[5:21]
SAO = ("type_idx", "eo_class", "band_pos", "offsets")
TU_FIELDS = ("cidx", "x", "y", "log2", "intra_mode", "qp", "transform_skip",
             "tq_bypass", "pred_mode", "cross_comp_alpha", "explicit_rdpcm")
PU_FIELDS = ("x", "y", "w", "h", "pred_flag", "mv", "ref_idx", "ref_poc",
             "ref_dpb")


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _jax_plans(data, monkeypatch):
    import libde265_tpu.decoder as jd
    from libde265_tpu.plan import grey_planes
    plans = []
    orig = jd.Decoder._finish_picture

    def finish(self):
        if self.img is not None:
            plans.append(self.img)
        return orig(self)
    monkeypatch.setattr(jd, "reconstruct_frame",
                        lambda img, dpb_images=None:
                        grey_planes(img.sps, img.W, img.H))
    monkeypatch.setattr(jd.Decoder, "_finish_picture", finish)
    dec = jd.Decoder()
    dec.push_data(data)
    dec.flush()
    dec.decode_all()
    return plans


def _port_plans(data, monkeypatch):
    """(plans, bridged views) of the port's per-picture decoder, the views
    made as _reconstruct makes them."""
    from libde265_tpu_torch import decoder as pd
    from libde265_tpu_torch.device_stream import bridge_plan
    from libde265_tpu_torch.plan import grey_planes
    plans, views = [], []

    def reconstruct(self, img, pic):
        fid_of = {i: p.plan.frame_id for i, p in enumerate(self.dpb.pics)
                  if p.plan is not None}
        views.append(bridge_plan(img, img.frame_id, img.nal_type,
                                 pic.pic_output_flag, fid_of))
        plans.append(img)
        pic.planes = grey_planes(img.sps, img.W, img.H)
    monkeypatch.setattr(pd.PictureDecoder, "_reconstruct", reconstruct)
    dec = pd.PictureDecoder(device="cpu")
    dec.push_data(data)
    dec.flush()
    dec.decode_all()
    return plans, views


def _same_record(a, b, fields):
    for f in fields:
        if getattr(a, f) != getattr(b, f):
            return False
    return True


@pytest.mark.parametrize("name", VECTORS)
def test_slice_reader_matches_jax(name, monkeypatch):
    data = _load(name)
    want = _jax_plans(data, monkeypatch)
    got, _ = _port_plans(data, monkeypatch)
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.poc == w.poc
        for grid in GRIDS:
            assert np.array_equal(getattr(g, grid), getattr(w, grid)), \
                (name, k, grid)
        for a in SAO:
            assert np.array_equal(getattr(g.sao, a), getattr(w.sao, a)), \
                (name, k, a)
        assert len(g.slice_headers) == len(w.slice_headers)
        assert len(g.tus) == len(w.tus) and len(g.pus) == len(w.pus)
        for tg, tw in zip(g.tus, w.tus):
            assert _same_record(tg, tw, TU_FIELDS), (name, k, tg, tw)
            if tg.cidx == -1:
                assert np.array_equal(tg.pcm_y, tw.pcm_y)
                assert np.array_equal(tg.pcm_c, tw.pcm_c)
            elif tw.coeffs is None:
                assert tg.coeffs is None
            else:
                assert np.array_equal(tg.coeffs, tw.coeffs), (name, k)
        for pg, pw in zip(g.pus, w.pus):
            assert _same_record(pg, pw, PU_FIELDS), (name, k, pg, pw)
            assert g.slice_headers.index(pg.slice_header) == \
                w.slice_headers.index(pw.slice_header)


@pytest.mark.parametrize("name", VECTORS)
def test_bridge_matches_native_plans(name, monkeypatch):
    """The bridged views in the native layout: every grid, the SAO
    arrays and the TU / PU tables equal to the native front end's plans
    (frame ids mapped by decode order; no grey stand-ins in these
    streams)."""
    from libde265_tpu_torch.api import _parse
    from libde265_tpu_torch.plan import PU_FID0, PU_PF0, tu_table, pu_table
    data = _load(name)
    _, views = _port_plans(data, monkeypatch)
    nps = [p for p in _parse(data) if p.nal_type != -1]
    assert len(views) == len(nps) > 0
    fmap = {v.frame_id: p.frame_id for v, p in zip(views, nps)}
    for k, (v, p) in enumerate(zip(views, nps)):
        assert (v.poc, v.nal_type) == (p.poc, p.nal_type)
        for grid in NATIVE_GRIDS:
            assert np.array_equal(getattr(v, grid), getattr(p, grid)), \
                (name, k, grid)
        for a in SAO:
            assert np.array_equal(getattr(v.sao, a), getattr(p.sao, a))
        for a, b in zip(v._tu_arrays, tu_table(p)):
            assert np.array_equal(a, b), (name, k)
        pm = v._pu_arrays[0].copy()
        for l in range(2):
            used = pm[:, PU_PF0 + l] > 0
            pm[used, PU_FID0 + l] = [fmap[int(f)]
                                     for f in pm[used, PU_FID0 + l]]
        assert np.array_equal(pm, pu_table(p)), (name, k)
