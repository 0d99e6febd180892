"""hdrcopy: parse an HEVC stream's headers, print their fields and copy
its parameter sets (counterpart of the JAX package's tools/hdrcopy.py
and of libde265's hdrcopy). The decoder-side parsers of bitstream/ read
VPS, SPS, PPS and (with --slices) slice headers; --copy writes the
parameter-set NALs, re-escaped, to a new file. Host work only.

    python -m libde265_tpu_torch.tools.hdrcopy stream.bin [--slices] \
        [--copy out.bin]
"""
import argparse
import sys

from ..bitstream.nal import split_annexb
from ..bitstream.paramsets import read_pps, read_sps, read_vps
from ..bitstream.sliceheader import read_slice_header
from ..encoder.cabac_enc import add_emulation_prevention

NAL_NAMES = {0: "TRAIL_N", 1: "TRAIL_R", 2: "TSA_N", 3: "TSA_R",
             16: "BLA_W_LP", 17: "BLA_W_RADL", 18: "BLA_N_LP",
             19: "IDR_W_RADL", 20: "IDR_N_LP", 21: "CRA_NUT",
             32: "VPS", 33: "SPS", 34: "PPS", 35: "AUD",
             39: "PREFIX_SEI", 40: "SUFFIX_SEI"}

VPS_KEYS = ["video_parameter_set_id", "max_sub_layers",
            "temporal_id_nesting_flag", "max_dec_pic_buffering",
            "max_num_reorder_pics"]
SPS_KEYS = ["seq_parameter_set_id", "chroma_format_idc",
            "pic_width_in_luma_samples", "pic_height_in_luma_samples",
            "bit_depth_luma", "bit_depth_chroma",
            "log2_max_pic_order_cnt_lsb", "max_sub_layers",
            "log2_min_luma_coding_block_size",
            "log2_diff_max_min_luma_coding_block_size",
            "sample_adaptive_offset_enabled_flag",
            "pcm_enabled_flag", "sps_temporal_mvp_enabled_flag",
            "strong_intra_smoothing_enabled_flag",
            "scaling_list_enable_flag", "amp_enabled_flag",
            "long_term_ref_pics_present_flag"]
VUI_KEYS = ["sar_width", "sar_height", "timing_info_present",
            "num_units_in_tick", "time_scale", "video_full_range_flag",
            "colour_primaries", "transfer_characteristics", "matrix_coeffs"]
PPS_KEYS = ["pic_parameter_set_id", "sps_id",
            "dependent_slice_segments_enabled_flag",
            "cabac_init_present_flag", "num_ref_idx_l0_default_active",
            "num_ref_idx_l1_default_active", "init_qp",
            "cu_qp_delta_enabled_flag", "diff_cu_qp_delta_depth",
            "pps_cb_qp_offset", "pps_cr_qp_offset",
            "weighted_pred_flag", "weighted_bipred_flag",
            "transquant_bypass_enable_flag", "tiles_enabled_flag",
            "entropy_coding_sync_enabled_flag", "sign_data_hiding_flag",
            "transform_skip_enabled_flag",
            "loop_filter_across_slices_enabled_flag"]
SLICE_KEYS = ["slice_type", "slice_pic_order_cnt_lsb",
              "first_slice_segment_in_pic_flag",
              "dependent_slice_segment_flag", "slice_qp",
              "num_ref_idx_l0_active", "num_ref_idx_l1_active",
              "slice_temporal_mvp_enabled_flag",
              "five_minus_max_num_merge_cand"]


def dump_obj(name, obj, keys):
    print(f"----------------- {name} -----------------")
    for k in keys:
        if hasattr(obj, k):
            print(f"{k:40s}: {getattr(obj, k)}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hdrcopy")
    ap.add_argument("stream")
    ap.add_argument("--copy", help="write parameter-set NALs to this file")
    ap.add_argument("--slices", action="store_true",
                    help="also dump slice headers")
    args = ap.parse_args(argv)

    with open(args.stream, "rb") as f:
        data = f.read()
    spss, ppss = {}, {}
    out = bytearray()
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        name = NAL_NAMES.get(t, str(t))
        if t == 32:
            dump_obj(f"VPS {name}", read_vps(u.data), VPS_KEYS)
            out += b"\x00\x00\x00\x01" + add_emulation_prevention(u.data)
        elif t == 33:
            s = read_sps(u.data)
            spss[s.seq_parameter_set_id] = s
            dump_obj(f"SPS {name}", s, SPS_KEYS)
            if s.vui is not None:
                dump_obj("VUI", s.vui, VUI_KEYS)
                if s.vui.frame_rate:
                    print(f"{'frame_rate':40s}: {s.vui.frame_rate:.3f}")
            out += b"\x00\x00\x00\x01" + add_emulation_prevention(u.data)
        elif t == 34:
            p = read_pps(u.data, spss)
            ppss[p.pic_parameter_set_id] = p
            dump_obj(f"PPS {name}", p, PPS_KEYS)
            out += b"\x00\x00\x00\x01" + add_emulation_prevention(u.data)
        elif t <= 31 and args.slices and ppss:
            try:
                sh = read_slice_header(u.data, u.header, ppss, spss)
                dump_obj(f"slice {name}", sh, SLICE_KEYS)
            except Exception as e:  # keep dumping past a damaged slice
                print(f"slice {name}: <parse failed: {e}>")

    if args.copy:
        with open(args.copy, "wb") as f:
            f.write(bytes(out))
        print(f"wrote {len(out)} bytes of parameter sets to {args.copy}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
