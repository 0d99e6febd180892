"""On-device derivation of loop-filter metadata from decode-plan grids.

Counterpart of libde265_tpu/ops/filter_plan_jax.py: boundary strength
and deblock metadata (reference deblock.cc:130-377, 1020-1058) and the
per-sample SAO maps (sao.cc:140-200), derived from the packed 4x4/CTB
grids. With xoff=0 the grids cover the whole frame and CTB-level arrays
expand by block repeats; with xoff != 0 they are the halo-extended strip
of a tile column whose first column sits at global luma x = xoff
(parallel/tile_shard.py), and CTB-level lookups take global coordinates,
clipped into the picture. The small spec tables are indexed directly
(the JAX version unrolls them as select chains, a TPU gather
workaround).
"""
import numpy as np
import torch

from ..convert import device_table
from .deblock import TC_ARR
from .deblock_ref import CHROMA_QP_TABLE

CHROMA_QP_ARR = np.asarray(CHROMA_QP_TABLE, np.int32)


def _far(mva, mvb):
    """|mv delta| >= 4 in either component. mva/mvb: (..., 2)."""
    return ((mva[..., 0] - mvb[..., 0]).abs() >= 4) | \
           ((mva[..., 1] - mvb[..., 1]).abs() >= 4)


def _bs_motion(pf_p, mv_p, poc_p, pf_q, mv_q, poc_q):
    """Spec 8.7.2.4 motion-difference test -> bs (0 or 1).
    pf_*: (..., 2) int; mv_*: (..., 2, 2); poc_*: (..., 2)."""
    np_ = pf_p[..., 0] + pf_p[..., 1]
    nq_ = pf_q[..., 0] + pf_q[..., 1]

    # single prediction each side: compare the one active lane
    p_has0 = pf_p[..., 0] > 0
    q_has0 = pf_q[..., 0] > 0
    pocp1 = torch.where(p_has0, poc_p[..., 0], poc_p[..., 1])
    pocq1 = torch.where(q_has0, poc_q[..., 0], poc_q[..., 1])
    mvp1 = torch.where(p_has0[..., None], mv_p[..., 0, :], mv_p[..., 1, :])
    mvq1 = torch.where(q_has0[..., None], mv_q[..., 0, :], mv_q[..., 1, :])
    single = (pocp1 != pocq1) | _far(mvp1, mvq1)

    # two predictions each side
    pp0, pp1 = poc_p[..., 0], poc_p[..., 1]
    qq0, qq1 = poc_q[..., 0], poc_q[..., 1]
    set_neq = (torch.minimum(pp0, pp1) != torch.minimum(qq0, qq1)) | \
              (torch.maximum(pp0, pp1) != torch.maximum(qq0, qq1))
    p0, p1 = mv_p[..., 0, :], mv_p[..., 1, :]
    q0, q1 = mv_q[..., 0, :], mv_q[..., 1, :]
    same_ref = pp0 == pp1
    both_same = (_far(p0, q0) | _far(p1, q1)) & (_far(p0, q1) | _far(p1, q0))
    # distinct pictures: align q to p by POC
    swap = pp0 != qq0
    q0a = torch.where(swap[..., None], q1, q0)
    q1a = torch.where(swap[..., None], q0, q1)
    aligned = _far(p0, q0a) | _far(p1, q1a)
    double = set_neq | torch.where(same_ref, both_same, aligned)

    one = torch.ones_like(np_)
    zero = torch.zeros_like(np_)
    return torch.where(np_ != nq_, one,
                       torch.where(np_ == 1, single.to(np_.dtype),
                                   torch.where(np_ == 2,
                                               double.to(np_.dtype), zero)))


def _expand_edge_ctb(arr_ctb, s_luma, e_luma, log2ctb):
    """CTB grid -> edge grid at GLOBAL luma positions s_luma (rows) and
    e_luma (edges), clipped into the picture: halo positions of a strip
    read their nearest in-picture CTB and are cropped by the caller."""
    nctby, nctbx = arr_ctb.shape
    cy = torch.clamp(s_luma >> log2ctb, 0, nctby - 1)
    cx = torch.clamp(e_luma >> log2ctb, 0, nctbx - 1)
    return arr_ctb[cy][:, cx]


def _expand_edge_ctb_fast(arr_ctb, n_s, n_e, log2ctb, edge_px):
    """xoff == 0 form of _expand_edge_ctb: row r covers luma y=4r, edge e
    covers luma x=edge_px*(e+1) (broadcast-repeat + crop)."""
    ry = (1 << log2ctb) // 4
    rx = (1 << log2ctb) // edge_px
    rows = torch.repeat_interleave(arr_ctb, ry, dim=0)[:n_s]
    return torch.repeat_interleave(rows, rx, dim=1)[:, 1:1 + n_e]


def _edge_lookup(allow, sidx_, n_s, n_e, log2ctb, edge_px, xoff, vertical):
    """(is_ctb (n_e,), allow_e (n_s, n_e) bool, se (n_s, n_e)): whether
    each edge lies on a CTB boundary, the CTB-pair permission and the
    slice-table row of every edge segment."""
    dev = allow.device
    ctb_mask = (1 << log2ctb) - 1
    if xoff == 0:
        allow_e = _expand_edge_ctb_fast(allow, n_s, n_e, log2ctb,
                                        edge_px) != 0
        se = _expand_edge_ctb_fast(sidx_, n_s, n_e, log2ctb, edge_px)
        is_ctb = (((torch.arange(n_e, device=dev) + 1) * edge_px)
                  & ctb_mask) == 0
        return is_ctb, allow_e, se
    # global coordinates for the CTB-level lookups (xoff: strip origin)
    e_x = (torch.arange(n_e, device=dev) + 1) * edge_px \
        + (xoff if vertical else 0)
    s_y = torch.arange(n_s, device=dev) * 4 + (0 if vertical else xoff)
    is_ctb = (e_x & ctb_mask) == 0
    allow_e = _expand_edge_ctb(allow, s_y, e_x, log2ctb) != 0
    return is_ctb, allow_e, _expand_edge_ctb(sidx_, s_y, e_x, log2ctb)


def plan_deblock_device(grids, cfg, xoff=0):
    """grids: dict of tensors (packing.pack_frame keys, unpacked).
    cfg: (log2ctb, pcm_lf_disable, chroma_fmt, bd_y, bd_c, cb_qpoff,
    cr_qpoff, H, W). xoff: global luma x of the grids' first column (a
    python int; 0 for a whole frame). Returns (lm, cm): luma (v, h)
    tuples (bs, qp, beta_off, tc_off, p_off, q_off) and chroma
    (act, tc, p_off, q_off)."""
    (log2ctb, pcm_lfd, chroma_fmt, bd_y, bd_c, cb_qpoff, cr_qpoff,
     H, W) = cfg
    i32 = torch.int32
    pm = grids["pm"].to(i32)
    dev = pm.device
    cbf = grids["cbf"].to(i32)
    tucb = grids["tucb"].to(i32)
    edgeall = grids["edgeall"].to(i32)
    qp = grids["qp"].to(i32)
    off = grids["off"].to(i32)
    pf = grids["pf"].to(i32)
    mv = grids["mv"].to(i32)
    poc = grids["poc"].to(i32)
    sidx = grids["sidx"].to(torch.int64)
    allow_v = grids["allow_v"].to(i32)
    allow_h = grids["allow_h"].to(i32)
    dis_tab = grids["sh_disable"].to(i32)
    beta_tab = grids["sh_beta"].to(i32)
    tc_tab = grids["sh_tc"].to(i32)

    def luma_dir(vertical):
        if vertical:
            (pm_, cbf_, tucb_, edge_, qp_, off_, pf_, mv_, poc_) = (
                pm, cbf, tucb, edgeall, qp, off, pf, mv, poc)
            allow, sidx_, bit = allow_v, sidx, 1
        else:
            def tr(a):
                return a.transpose(0, 1)
            (pm_, cbf_, tucb_, edge_, qp_, off_, pf_, mv_, poc_) = (
                tr(pm), tr(cbf), tr(tucb), tr(edgeall), tr(qp), tr(off),
                tr(pf), tr(mv), tr(poc))
            allow, sidx_, bit = tr(allow_h), tr(sidx), 2
        We = pm_.shape[1] * 4
        n_e = We // 8 - 1
        n_s = pm_.shape[0]

        def atq(a):
            return a[:, 2:2 + 2 * n_e:2]

        def atp(a):
            return a[:, 1:1 + 2 * n_e:2]
        is_ctb, allow_e, se = _edge_lookup(allow, sidx_, n_s, n_e, log2ctb,
                                           8, xoff, vertical)
        # CTB-boundary permission (tiles/slices); interior edges always ok
        allowed = torch.where(is_ctb[None, :], allow_e, True)
        disabled = dis_tab[se] != 0
        beta_off = beta_tab[se]
        tc_off = tc_tab[se]

        edge_exists = (atq(edge_) & bit) != 0
        pm_q, pm_p = atq(pm_), atp(pm_)
        intra2 = (pm_q == 1) | (pm_p == 1)
        tu_edge = (atq(tucb_) & bit) != 0
        b1 = tu_edge & ((atq(cbf_) > 0) | (atp(cbf_) > 0))
        mvbs = _bs_motion(atp(pf_), atp(mv_), atp(poc_),
                          atq(pf_), atq(mv_), atq(poc_))
        bs = torch.where(intra2, 2, torch.where(b1, 1, mvbs))
        valid = edge_exists & allowed & ~disabled
        bs = torch.where(valid, bs, 0)
        qp_avg = (atp(qp_) + atq(qp_) + 1) >> 1
        p_off = atp(off_) != 0
        q_off = atq(off_) != 0
        return (bs, qp_avg, beta_off, tc_off, p_off, q_off)

    lm = (luma_dir(True), luma_dir(False))
    if not chroma_fmt:
        return lm, None
    tc_arr = device_table("TC", TC_ARR, dev)
    cqp_arr = device_table("CHROMA_QP", CHROMA_QP_ARR, dev)

    def chroma_dir(vertical):
        # chroma edges sit at chroma x/y = 8*(ei+1): luma spacing 8*sub
        # along the perpendicular axis (deblock.cc:738-757)
        subw = 2 if chroma_fmt in (1, 2) else 1
        subh = 2 if chroma_fmt == 1 else 1
        if vertical:
            pm_, qp_, tucb_, off_ = pm, qp, tucb, off
            allow, sidx_, bit = allow_v, sidx, 1
            sp = 8 * subw
        else:
            def tr(a):
                return a.transpose(0, 1)
            pm_, qp_, tucb_, off_ = tr(pm), tr(qp), tr(tucb), tr(off)
            allow, sidx_, bit = tr(allow_h), tr(sidx), 2
            sp = 8 * subh
        st = sp // 4                         # edge stride in 4x4 blocks
        We = pm_.shape[1] * 4
        n_e = We // sp - (1 if We % sp == 0 else 0)
        n_s = pm_.shape[0]

        def atq(a):
            return a[:, st:st + st * n_e:st]

        def atp(a):
            return a[:, st - 1:st - 1 + st * n_e:st]
        is_ctb, allow_e, se = _edge_lookup(allow, sidx_, n_s, n_e, log2ctb,
                                           sp, xoff, vertical)
        edge_exists = (atq(tucb_) & bit) != 0
        allowed = torch.where(is_ctb[None, :], allow_e, True)
        disabled = dis_tab[se] != 0
        tc_off = tc_tab[se]
        intra2 = (atq(pm_) == 1) | (atp(pm_) == 1)
        valid = edge_exists & allowed & ~disabled & intra2
        qp_avg = (atp(qp_) + atq(qp_) + 1) >> 1
        acts, tcs = [], []
        for qoff in (cb_qpoff, cr_qpoff):
            qpi = torch.clamp(qp_avg + qoff, 0, 57)
            if chroma_fmt == 1:
                qpc = torch.where(
                    qpi < 30, qpi,
                    torch.where(qpi > 43, qpi - 6,
                                cqp_arr[torch.clamp(qpi - 30, 0, 13)]))
            else:
                qpc = torch.clamp(qpi, max=51)
            Qt = torch.clamp(qpc + 2 + tc_off, 0, 53)
            tcv = tc_arr[Qt] << (bd_c - 8)
            acts.append(valid & (tcv > 0))
            tcs.append(torch.where(valid, tcv, 0))
        p_off = atp(off_) != 0
        q_off = atq(off_) != 0
        return (torch.stack(acts), torch.stack(tcs), p_off, q_off)

    cm = (chroma_dir(True), chroma_dir(False))
    return lm, cm


def plan_sao_device(grids, cfg, cidx, xoff=0):
    """Expand per-CTB SAO params to per-sample maps.
    grids: sao_type/eo/band (nctby,nctbx,3), sao_off (nctby,nctbx,3,4),
    sidx, sh_sao_luma/chroma (S,), off (4x4 tq/pcm grid, possibly a
    halo-extended strip), pair_ok (4,nctby,nctbx). cfg: (log2ctb,
    chroma_fmt, H, W, subw, subh). xoff: global luma x of the off grid's
    first column. CTB-level arrays are always global; the plane width
    follows the off grid. Returns (type_map, eo_map, band_map, off_maps,
    skip, avail)."""
    log2ctb, chroma_fmt, H, W, subw, subh = cfg
    sub = 1 if cidx == 0 else subw
    subv = 1 if cidx == 0 else subh
    Hs = H // subv
    Ws = (grids["off"].shape[1] * 4) // sub
    ctb = (1 << log2ctb) // sub
    ctbv = (1 << log2ctb) // subv

    # int8 per-CTB params: type<=2, eo<=3, band<=31, |offset|<=31
    t = grids["sao_type"][:, :, cidx].to(torch.int8)
    dev = t.device
    eo = grids["sao_eo"][:, :, cidx].to(torch.int8)
    band = grids["sao_band"][:, :, cidx].to(torch.int8)
    offs = grids["sao_off"][:, :, cidx, :].to(torch.int8)
    sidx = grids["sidx"].to(torch.int64)
    en_tab = (grids["sh_sao_luma"] if cidx == 0 else
              grids["sh_sao_chroma"]).to(torch.int32)
    enable = en_tab[sidx] != 0
    t = torch.where(enable, t, 0).to(torch.int8)

    nctby, nctbx = t.shape
    # global plane-unit coordinates of each strip sample
    gx_plane = torch.arange(Ws, device=dev) + xoff // sub
    if xoff == 0:
        def expand(a):
            return a[:, None, :, None].expand(nctby, ctbv, nctbx, ctb) \
                .reshape(nctby * ctbv, nctbx * ctb)[:Hs, :Ws]
    else:
        ys_c = torch.clamp(torch.arange(Hs, device=dev) // ctbv, 0,
                           nctby - 1)
        xs_c = torch.clamp(gx_plane // ctb, 0, nctbx - 1)

        def expand(a):
            return a[ys_c][:, xs_c]

    type_map = expand(t)
    eo_map = expand(eo)
    band_map = expand(band)
    off_maps = torch.stack([expand(offs[:, :, k]) for k in range(4)], dim=0)

    # per-sample skip (pcm/tq-bypass) from the (strip-local) 4x4 grid
    og = grids["off"]
    fy, fx = 4 // subv, 4 // sub
    oh, ow = og.shape
    skip = og[:, None, :, None].expand(oh, fy, ow, fx) \
        .reshape(oh * fy, ow * fx)[:Hs, :Ws] != 0

    # neighbor availability: expand CTB-pair-ok to boundary samples
    pair_ok = grids["pair_ok"]                  # (4, nctby, nctbx) bool
    ys = torch.arange(Hs, device=dev)
    at_l = (gx_plane % ctb) == 0
    at_r = ((gx_plane % ctb) == (ctb - 1)) | (gx_plane == (W // sub - 1))
    at_u = (ys % ctbv) == 0
    at_d = ((ys % ctbv) == (ctbv - 1)) | (ys == (Hs - 1))
    ok = [expand(pair_ok[k].to(torch.int8)) != 0 for k in range(4)]
    avail = torch.stack([
        ~at_l[None, :] | ok[0],
        ~at_r[None, :] | ok[1],
        (~at_u[:, None]) | ok[2],
        (~at_d[:, None]) | ok[3],
    ])
    return type_map, eo_map, band_map, off_maps, skip, avail


def plan_sao_compact(grids, cfg, cidx, xoff=0):
    """Fold plan_sao_device's per-sample maps into the three compact int8
    maps that K3's plain version applies (ops/kernels/sao_filter.py; the
    kernel derives them per sample from the CTB parameters): mode
    (0 off / 1 band / 2 edge, with skip + availability + picture boundary
    folded into 0), aux (band position or EO class), offs (4, H, W)."""
    t, eo, band, offs, skip, avail = plan_sao_device(grids, cfg, cidx,
                                                     xoff)
    okh = avail[0] & avail[1]
    okv = avail[2] & avail[3]
    ok = torch.where(eo == 0, okh, torch.where(eo == 1, okv, okh & okv))
    mode = torch.where(skip | ((t == 2) & ~ok), 0, t).to(torch.int8)
    aux = torch.where(t == 1, band, eo).to(torch.int8)
    return mode, aux, offs
