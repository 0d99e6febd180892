"""Copy of libde265_tpu/encoder/headers.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

VPS/SPS/PPS/slice-header writers (spec 7.3.2, 7.3.6).

Capability counterpart of the write() halves of libde265/
{vps,sps,pps}.cc and slice.cc:882-1246, for the en265-equivalent encoder.
Emits minimal-but-conforming Main-profile headers.
"""
from .cabac_enc import BitWriter, add_emulation_prevention
from ..bitstream.nal import NAL_VPS_NUT, NAL_SPS_NUT, NAL_PPS_NUT


def nal_header(w: BitWriter, nal_type: int, tid: int = 0):
    w.put_bit(0)
    w.put_bits(nal_type, 6)
    w.put_bits(0, 6)          # nuh_layer_id
    w.put_bits(tid + 1, 3)    # nuh_temporal_id_plus1


def write_ptl(w: BitWriter, max_sub_layers: int = 1, profile_idc: int = 1):
    w.put_bits(0, 2)     # profile_space
    w.put_bit(0)         # tier
    w.put_bits(profile_idc, 5)   # 1 = Main, 2 = Main-10
    w.put_bits(0b01100000000000000000000000000000, 32)  # compat: Main(+10?) bits 1,2
    w.put_bits(0, 32)    # constraint flags (44 bits total -> 32+12)
    w.put_bits(0, 12)
    w.put_bits(0, 4)     # reserved (to total 48 after compat)
    w.put_bits(120, 8)   # level_idc 4.0
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1):
            w.put_bit(0)  # sub_layer_profile_present
            w.put_bit(0)  # sub_layer_level_present
        for _ in range(max_sub_layers - 1, 8):
            w.put_bits(0, 2)  # reserved


def write_vps(width=0, height=0):
    w = BitWriter()
    nal_header(w, NAL_VPS_NUT)
    w.put_bits(0, 4)   # vps id
    w.put_bits(3, 2)   # reserved '11'
    w.put_bits(0, 6)   # max_layers_minus1
    w.put_bits(0, 3)   # max_sub_layers_minus1
    w.put_bit(1)       # temporal_id_nesting
    w.put_bits(0xFFFF, 16)
    write_ptl(w)
    w.put_bit(0)       # sub_layer_ordering_info_present
    w.put_uvlc(3)      # max_dec_pic_buffering_minus1
    w.put_uvlc(0)      # num_reorder_pics
    w.put_uvlc(0)      # max_latency
    w.put_bits(0, 6)   # max_layer_id
    w.put_uvlc(0)      # num_layer_sets_minus1
    w.put_bit(0)       # timing_info_present
    w.put_bit(0)       # extension
    w.rbsp_trailing()
    return add_emulation_prevention(w.data())


def write_sps(cfg):
    w = BitWriter()
    nal_header(w, NAL_SPS_NUT)
    w.put_bits(0, 4)   # vps id
    msl = 2 if getattr(cfg, 'temporal_layers', False) else 1
    w.put_bits(msl - 1, 3)   # max_sub_layers_minus1
    w.put_bit(1)       # temporal_id_nesting
    cf_ptl = getattr(cfg, 'chroma_format', 1)
    write_ptl(w, msl, profile_idc=4 if cf_ptl != 1 else
              (2 if getattr(cfg, 'bit_depth', 8) > 8 else 1))
    w.put_uvlc(0)      # sps id
    cf = getattr(cfg, 'chroma_format', 1)
    w.put_uvlc(cf)     # chroma_format_idc (0 mono / 1 420 / 2 422 / 3 444)
    if cf == 3:
        w.put_bit(0)   # separate_colour_plane_flag
    w.put_uvlc(cfg.width)
    w.put_uvlc(cfg.height)
    w.put_bit(0)       # conformance window
    bd = getattr(cfg, 'bit_depth', 8)
    w.put_uvlc(bd - 8)  # bit_depth_luma_minus8
    w.put_uvlc(bd - 8)  # bit_depth_chroma_minus8
    w.put_uvlc(cfg.log2_max_poc_lsb - 4)
    w.put_bit(0)       # sub_layer_ordering_info_present
    w.put_uvlc(3)      # max_dec_pic_buffering_minus1
    w.put_uvlc(0)      # num_reorder_pics
    w.put_uvlc(0)      # max_latency
    w.put_uvlc(cfg.log2_min_cb - 3)
    w.put_uvlc(cfg.log2_ctb - cfg.log2_min_cb)
    w.put_uvlc(cfg.log2_min_tb - 2)
    w.put_uvlc(cfg.log2_max_tb - cfg.log2_min_tb)
    w.put_uvlc(cfg.max_transform_hierarchy_depth_inter)
    w.put_uvlc(cfg.max_transform_hierarchy_depth_intra)
    if getattr(cfg, "scaling_lists", False):
        w.put_bit(1)   # scaling_list_enable
        w.put_bit(0)   # sps_scaling_list_data_present -> default lists
    else:
        w.put_bit(0)   # scaling_list_enable
    w.put_bit(1 if cfg.amp else 0)
    w.put_bit(1 if cfg.sao else 0)
    if getattr(cfg, 'pcm', False):
        w.put_bit(1)   # pcm_enabled
        w.put_bits(getattr(cfg, 'bit_depth', 8) - 1, 4)  # pcm bd luma -1
        w.put_bits(getattr(cfg, 'bit_depth', 8) - 1, 4)  # pcm bd chroma -1
        w.put_uvlc(0)  # log2_min_pcm_cb - 3  (8x8)
        w.put_uvlc(2)  # log2_diff_max_min (up to 32)
        w.put_bit(1 if getattr(cfg, 'pcm_loop_filter_disable', False) else 0)
    else:
        w.put_bit(0)   # pcm_enabled
    w.put_uvlc(0)      # num_short_term_ref_pic_sets
    if getattr(cfg, 'use_ltr', False):
        w.put_bit(1)   # long_term_ref_pics_present
        w.put_uvlc(0)  # num_long_term_ref_pics_sps
    else:
        w.put_bit(0)   # long_term_ref_pics_present
    w.put_bit(1 if cfg.temporal_mvp else 0)
    w.put_bit(1 if cfg.strong_intra_smoothing else 0)
    fps = getattr(cfg, 'fps', 0)
    if fps:
        w.put_bit(1)   # vui_present (timing info only, spec E.2.1)
        w.put_bit(0)   # aspect_ratio_info_present
        w.put_bit(0)   # overscan_info_present
        w.put_bit(0)   # video_signal_type_present
        w.put_bit(0)   # chroma_loc_info_present
        w.put_bits(0, 3)  # neutral_chroma, field_seq, frame_field_info
        w.put_bit(0)   # default_display_window
        w.put_bit(1)   # vui_timing_info_present
        w.put_bits(1000, 32)              # num_units_in_tick
        w.put_bits(int(fps * 1000), 32)   # time_scale
        w.put_bit(0)   # poc_proportional_to_timing
        w.put_bit(0)   # hrd_parameters_present
        w.put_bit(0)   # bitstream_restriction
    else:
        w.put_bit(0)   # vui_present
    # SPS range extension (spec 7.3.2.2.2) — emitted when any rext
    # residual tool is configured (round 5)
    sps_rext = any(getattr(cfg, k, False) for k in (
        "tskip_rotation", "transform_skip_context", "implicit_rdpcm",
        "explicit_rdpcm", "persistent_rice", "intra_smoothing_disabled"))
    if sps_rext:
        w.put_bit(1)   # sps_extension_present
        w.put_bit(1)   # sps_range_extension_flag
        w.put_bits(0, 7)  # multilayer + 6 reserved bits
        w.put_bit(1 if getattr(cfg, "tskip_rotation", False) else 0)
        w.put_bit(1 if getattr(cfg, "transform_skip_context", False) else 0)
        w.put_bit(1 if getattr(cfg, "implicit_rdpcm", False) else 0)
        w.put_bit(1 if getattr(cfg, "explicit_rdpcm", False) else 0)
        w.put_bit(0)   # extended_precision_processing
        w.put_bit(1 if getattr(cfg, "intra_smoothing_disabled", False) else 0)
        w.put_bit(0)   # high_precision_offsets
        w.put_bit(1 if getattr(cfg, "persistent_rice", False) else 0)
        w.put_bit(0)   # cabac_bypass_alignment
    else:
        w.put_bit(0)   # extension
    w.rbsp_trailing()
    return add_emulation_prevention(w.data())


def write_pps(cfg):
    w = BitWriter()
    nal_header(w, NAL_PPS_NUT)
    w.put_uvlc(0)      # pps id
    w.put_uvlc(0)      # sps id
    w.put_bit(1 if getattr(cfg, 'dependent_slices', False) else 0)  # dependent_slice_segments_enabled
    w.put_bit(0)       # output_flag_present
    w.put_bits(0, 3)   # num_extra_slice_header_bits
    w.put_bit(1 if cfg.sign_data_hiding else 0)
    w.put_bit(1 if getattr(cfg, 'cabac_init', False) else 0)  # cabac_init_present
    w.put_uvlc(cfg.num_ref_l0 - 1)
    # l1 default mirrors l0 for generalized-B configurations
    w.put_uvlc((cfg.num_ref_l0 - 1) if getattr(cfg, 'b_frames', False) else 0)
    w.put_svlc(cfg.qp - 26)
    w.put_bit(1 if getattr(cfg, 'constrained_intra', False) else 0)  # constrained_intra_pred
    w.put_bit(1 if cfg.transform_skip else 0)
    w.put_bit(1 if cfg.cu_qp_delta else 0)
    if cfg.cu_qp_delta:
        w.put_uvlc(cfg.diff_cu_qp_delta_depth)
    w.put_svlc(cfg.cb_qp_offset)
    w.put_svlc(cfg.cr_qp_offset)
    w.put_bit(0)       # slice_chroma_qp_offsets_present
    w.put_bit(1 if cfg.weighted_pred else 0)
    w.put_bit(0)       # weighted_bipred
    w.put_bit(1 if getattr(cfg, 'tq_bypass', False) else 0)  # transquant_bypass_enable
    w.put_bit(1 if cfg.tiles else 0)       # tiles_enabled
    w.put_bit(1 if cfg.wpp else 0)         # entropy_coding_sync
    if cfg.tiles:
        cols, rows = cfg.tiles
        w.put_uvlc(cols - 1)
        w.put_uvlc(rows - 1)
        tc = getattr(cfg, "tile_col_widths", None)   # explicit CTB widths
        tr = getattr(cfg, "tile_row_heights", None)
        if tc or tr:
            # uniform_spacing = 0: explicit column/row sizes in CTBs
            # (arbitrary PPS tile boundaries, pps.h:109-151); a missing
            # axis falls back to even splits of the CTB grid
            ctb = 1 << cfg.log2_ctb
            wctbs = -(-cfg.width // ctb)
            hctbs = -(-cfg.height // ctb)
            if not tc:
                tc = [(i + 1) * wctbs // cols - i * wctbs // cols
                      for i in range(cols)]
            if not tr:
                tr = [(i + 1) * hctbs // rows - i * hctbs // rows
                      for i in range(rows)]
            assert len(tc) >= cols - 1 and len(tr) >= rows - 1
            w.put_bit(0)
            for cw in tc[:cols - 1]:
                w.put_uvlc(cw - 1)
            for rh in tr[:rows - 1]:
                w.put_uvlc(rh - 1)
        else:
            w.put_bit(1)   # uniform_spacing
        w.put_bit(1 if cfg.lf_across_tiles else 0)
    w.put_bit(1)       # loop_filter_across_slices
    w.put_bit(1)       # deblocking_filter_control_present
    mixed = getattr(cfg, 'mixed_filter_slices', False)
    w.put_bit(1 if mixed else 0)   # deblocking_filter_override_enabled
    w.put_bit(1 if cfg.disable_deblocking else 0)
    if not cfg.disable_deblocking:
        w.put_svlc(0)  # beta offset /2
        w.put_svlc(0)  # tc offset /2
    w.put_bit(0)       # pic_scaling_list_present
    w.put_bit(1 if getattr(cfg, 'ref_list_reverse', False) else 0)  # lists_modification_present
    w.put_uvlc(0)      # log2_parallel_merge_level_minus2
    w.put_bit(0)       # slice_segment_header_extension
    # PPS range extension (spec 7.3.2.3.2): cross-component prediction
    # and/or TU-level chroma QP offset lists (round 5)
    ccp = getattr(cfg, "cross_comp_pred", False)
    cqol = getattr(cfg, "chroma_qp_offset_list", ())
    if ccp or cqol:
        w.put_bit(1)   # pps_extension_present
        w.put_bit(1)   # pps_range_extension_flag
        w.put_bits(0, 7)
        if cfg.transform_skip:
            w.put_uvlc(0)   # log2_max_transform_skip_block_size_minus2
        w.put_bit(1 if ccp else 0)
        w.put_bit(1 if cqol else 0)
        if cqol:
            w.put_uvlc(0)   # diff_cu_chroma_qp_offset_depth
            w.put_uvlc(len(cqol) - 1)
            for cb, cr in cqol:
                w.put_svlc(cb)
                w.put_svlc(cr)
        w.put_uvlc(0)  # log2_sao_offset_scale_luma
        w.put_uvlc(0)  # log2_sao_offset_scale_chroma
    else:
        w.put_bit(0)   # pps_extension
    w.rbsp_trailing()
    return add_emulation_prevention(w.data())


def write_slice_header(cfg, nal_type, slice_type, poc, first_ctb=0,
                       num_neg_refs=1, num_active=None, entry_points=None,
                       dependent=False, tid=0, ref_deltas=None,
                       lt_pocs=None, sao_flags=None, deblock_disabled=None,
                       qp_delta=0, list_mod=None):
    kwargs_dependent = [dependent]
    kwargs_lt = [lt_pocs or []]
    """Returns the BitWriter (caller appends CABAC data after alignment).
    slice_type: 0=B, 1=P, 2=I."""
    w = BitWriter()
    nal_header(w, nal_type, tid=tid)
    first = first_ctb == 0
    dependent = kwargs_dependent[0]
    w.put_bit(1 if first else 0)  # first_slice_segment_in_pic_flag
    if nal_type >= 16 and nal_type <= 23:
        w.put_bit(0)  # no_output_of_prior_pics
    w.put_uvlc(0)     # pps id
    if not first:
        if getattr(cfg, 'dependent_slices', False):
            w.put_bit(1 if dependent else 0)
        n = max(1, (cfg.pic_size_in_ctbs - 1).bit_length())
        w.put_bits(first_ctb, n)
    if dependent:
        if cfg.tiles or cfg.wpp:
            eps = entry_points or []
            w.put_uvlc(len(eps))
            if eps:
                olen = max(1, max(e.bit_length() for e in eps))
                w.put_uvlc(olen - 1)
                for e in eps:
                    w.put_bits(e - 1, olen)
        w.put_bit(1)
        w.byte_align_zero()
        return w
    w.put_uvlc(slice_type)
    if not (16 <= nal_type <= 20 and nal_type in (19, 20)):
        pass
    if nal_type not in (19, 20):  # not IDR: POC + RPS
        w.put_bits(poc % (1 << cfg.log2_max_poc_lsb), cfg.log2_max_poc_lsb)
        w.put_bit(0)   # short_term_ref_pic_set_sps_flag=0 -> explicit RPS
        # st_ref_pic_set(num_sets=0 -> idx 0, no inter_rps prediction)
        deltas = ref_deltas or [i + 1 for i in range(num_neg_refs)]
        w.put_uvlc(len(deltas))    # num_negative_pics
        w.put_uvlc(0)              # num_positive_pics
        prev = 0
        for d in deltas:           # d = distance to ref (increasing)
            w.put_uvlc(d - prev - 1)   # delta_poc_s0_minus1
            w.put_bit(1)           # used_by_curr_pic_s0
            prev = d
        if getattr(cfg, 'use_ltr', False):
            lt = kwargs_lt[0]
            w.put_uvlc(len(lt))    # num_long_term_pics
            for poc_lsb in lt:
                w.put_bits(poc_lsb, cfg.log2_max_poc_lsb)  # poc_lsb_lt
                w.put_bit(1)       # used_by_curr_pic_lt
                w.put_bit(0)       # delta_poc_msb_present
        if cfg.temporal_mvp:
            w.put_bit(1)           # slice_temporal_mvp_enabled
    sao_l, sao_c = sao_flags if sao_flags is not None else (1, 1)
    if cfg.sao:
        w.put_bit(sao_l)  # slice_sao_luma
        if getattr(cfg, 'chroma_format', 1) != 0:
            w.put_bit(sao_c)  # slice_sao_chroma (absent for monochrome)
    if slice_type != 2:
        if num_active is not None and num_active != cfg.num_ref_l0:
            w.put_bit(1)  # num_ref_idx_active_override
            w.put_uvlc(num_active - 1)
            if slice_type == 0:
                w.put_uvlc(num_active - 1)  # l1
        else:
            w.put_bit(0)  # num_ref_idx_active_override
        if getattr(cfg, 'ref_list_reverse', False):
            # ref_pic_lists_modification (7.3.6.2): list_mod =
            # (num_total, entries) with entries indexing the RPS order
            num_total, entries = list_mod if list_mod else (1, [])
            if num_total > 1:
                bits = max(1, (num_total - 1).bit_length())
                na = num_active if num_active is not None else cfg.num_ref_l0
                w.put_bit(1)
                for e in entries[:na]:
                    w.put_bits(e, bits)
                if slice_type == 0:
                    w.put_bit(1)
                    for e in entries[:na]:
                        w.put_bits(e, bits)
        if slice_type == 0:
            w.put_bit(1 if getattr(cfg, 'mvd_l1_zero', False) else 0)
        if getattr(cfg, 'cabac_init', False):
            w.put_bit(1)  # cabac_init_flag: swap P/B context init tables
        if cfg.temporal_mvp:
            # collocated_from_l0 defaults 1 for P; explicit for B
            if slice_type == 0:
                w.put_bit(1)   # collocated_from_l0_flag
            na = num_active if num_active is not None else cfg.num_ref_l0
            if na > 1:
                w.put_uvlc(0)  # collocated_ref_idx
        if cfg.weighted_pred and slice_type == 1:
            write_pred_weight_table(w, cfg,
                num_active if num_active is not None else cfg.num_ref_l0)
        w.put_uvlc(5 - cfg.max_merge_cand)
    w.put_svlc(qp_delta)     # slice_qp_delta (rate control / per-frame QP)
    if getattr(cfg, "chroma_qp_offset_list", ()):
        w.put_bit(1)         # cu_chroma_qp_offset_enabled_flag (rext)
    dbd = cfg.disable_deblocking
    if getattr(cfg, 'mixed_filter_slices', False) and deblock_disabled is not None:
        # deblocking_filter_override_enabled=1: per-slice override
        w.put_bit(1)               # deblocking_filter_override_flag
        w.put_bit(deblock_disabled)
        if not deblock_disabled:
            w.put_svlc(0)          # slice_beta_offset /2
            w.put_svlc(0)          # slice_tc_offset /2
        dbd = deblock_disabled
    if (cfg.sao and (sao_l or sao_c)) or not dbd:
        w.put_bit(1)  # slice_loop_filter_across_slices_enabled
    if cfg.tiles or cfg.wpp:
        eps = entry_points or []
        w.put_uvlc(len(eps))
        if eps:
            maxlen = max(e.bit_length() for e in eps)
            olen = max(1, maxlen)
            w.put_uvlc(olen - 1)
            for e in eps:
                w.put_bits(e - 1, olen)
    w.put_bit(1)      # alignment bit
    w.byte_align_zero()
    return w


def write_pred_weight_table(w, cfg, num_active):
    w.put_uvlc(cfg.luma_log2_weight_denom)
    w.put_svlc(0)  # delta_chroma_log2_weight_denom
    for i in range(num_active):
        w.put_bit(1)  # luma_weight_flag
    for i in range(num_active):
        w.put_bit(0)  # chroma_weight_flag
    for i in range(num_active):
        w.put_svlc(cfg.luma_weight_delta)
        w.put_svlc(cfg.luma_offset)
