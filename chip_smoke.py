#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (libde265_tpu_torch) on one CUDA
card.

1. prints the card (nvidia-smi name and power limit, torch's name);
2. builds native/libhevc_frontend.so if missing and the CUDA kernels
   (one nvcc per source, in parallel, sm_90a), printing the build
   seconds;
3. checks each kernel against its plain PyTorch version on the card,
   requiring exact equality, and times both with CUDA events; K1, K2,
   K3 and K5 are timed as calls replayed from a CUDA graph (their device
   time, without the host's enqueue of each call), and the output of
   every timed call is compared:
     K1 tile-table update: one 4K luma and one 4K chroma slot update
        into an 8-slot uint8 table (other slots pre-filled, must stay as
        they were), then one timed call into each of the 8 slots (the
        int16 tables of 10-bit streams in step 10); beside it
        the library yardstick k1_library (one strided copy_ and a zero_,
        equal to the plain version; the port never calls it);
     K2 MC: the first ld4k_light P frame's real grids over seeded random
        8-slot 4K tables (luma, then the [Cb|Cr] pair), a seeded 4K
        bi-predicted, explicitly weighted synthetic case, and a 10-bit
        case on int16 tables;
     K3 SAO from the per-CTB parameters: the three planes of the first
        ld4k_light P frame (its real grids) and of strip 1 of the 1080p
        tile stream's first P frame (x0 = 448, xoff = 432), over seeded
        random planes, against sao_ctb_plain;
     K4 intra scan (the CTB-row band wavefront): the whole intra_cif_q30
        IDR (plus the same inputs with availability holes), the whole
        ld4k_light IDR and the IDR of p_tiles4_1080p_mv (slots in tile
        scan), both plane groups each: the plain version once, then a
        warm-up and 20 timed calls of the wrapper, every one compared
        exactly with the plain output (a race between bands would show
        there); each case logs its critical path in TU steps (band_waits)
        beside its TU count, and the launch without band_waits and
        band_waits alone, each timed in a window of its own;
     K5 per-frame tile-table build, through its wrapper (a luma and a
        [Cb|Cr] launch): the reference slots that the last P frame of
        tests/data/p_tiles4_1080p_mv.bin takes from the DPB (R = 2, the
        tile path's shape), a seeded 4K stack of R = 8 frames into uint8
        tables, and a 72x136 R = 3 stack into int16 tables; beside it
        the library yardstick k5_library;
     K2 in strip form: the first P frame of tests/data/
        p_tiles4_1080p_mv.bin, tile column 1 (x0 = 448, a 448-pixel
        column in a 512-pixel strip), over seeded random tables;
     K6 deblocking (two launches, in place) against deblock_frame_plain
        on the real grids and pre-deblocking planes its callers see while
        streams decode on the card (tests/test_torch_cuda.py _dbk_inputs):
        the ld4k_light IDR and first P picture, the first ldb4k_main10 B
        picture, the gop1080p IDR and strip 1 of p_tiles4_1080p_mv's
        first P frame (xoff 432), each timed as 20 calls replayed from a
        CUDA graph (in place on one copy of the planes) beside its bound
        and the plain route's time; then, exact only, the first calls of
        4:2:2, 4:4:4, monochrome, pcm, pcm with its loop filter off,
        bypass, tile-boundary-off, per-slice-disabled and hybrid vectors,
        and the synthetic 8- to 12-bit cases (_dbk_case);
4. decodes all 33 frames of tests/data/ld4k_light.bin (3840x2160) through
   libde265_tpu_torch.api.decode_stream_native(data, device="cuda") with
   the launch counters zeroed just before, and requires every frame's
   per-plane MD5 to match tests/data/manifest_big.json, no frame on the
   numpy host path, and K1 = 66, K2 = 64, K3 = 99, K4 = 2, K6 = 66
   launches;
5. decodes the weighted and bi-predicted streams p_wp, adv_b_wp_2ref,
   b_mv and b_mixed the same way (counters zeroed before each), each
   MD5-checked against its manifest, and requires K2 launches in each;
6. decodes the six p_tiles*_mv vectors and p_tiles4_1080p_mv through the
   tile-column decoder (decode_stream_native(..., tile_devices=
   ["cuda:0"] * ncols): every strip on this card), counters zeroed before
   each: every frame MD5-equal to its manifest, no frame on the host
   path, every P frame decoded as strips, and the exact launch counts the
   code gives (K5 2 per strip frame, K2 2, K3 3 and K6 2 per strip, K1 2
   per frame, strip frames included, K3 3 and K6 2 per frame of the
   single-device program, K4 >= 1); with two
   cards, p_tiles2_mv again across cuda:0 and cuda:1;
7. times the 4K IDR and one 4K P frame through the frame program, and
   the 1080p tile stream's decode (wall) and one of its P frames through
   the strip program (CUDA events, packing excluded);
8. decode_all's runs (DeviceStreamDecoder.decode_all, the push path's
   engine: slots planned ahead, each run packed as one blob by the C++
   writer and uploaded once) on ld4k_light and on gop1080p (1920x1080,
   96 frames, 16 IDRs), from plans parsed once: a warm-up decode_all,
   decode_all, then a second decoder fed frame by frame (decode_plan),
   counters zeroed before each; it requires the same launch counts (on
   ld4k_light K1 66, K2 64, K3 99, K4 2), the final DPB stacks, tile
   tables and slot map exactly equal, and every output picture
   MD5-equal to manifest_big.json; it holds the C++-packed blob of
   eight ld4k_light P frames byte-identical to pack_frame + pack_blob,
   logs both walls (synchronised, parse excluded), their fps, the
   packing seconds and the frames the C++ writer filled, and runs one
   more ld4k_light decode_all under torch.cuda.set_sync_debug_mode(
   "warn"), logging the host syncs it reports by site and failing on
   any that is not an upload (convert.py) or a download
   (DeviceStreamDecoder._download);
9. decodes the 14 8-bit 4:2:0 vectors of the residual tools
   (transform-skip, transquant bypass, PCM, scaling lists; PART_B)
   through decode_stream_native(data, device="cuda"), counters zeroed
   before each: every frame MD5-equal, K4 launched in each, and the
   frames that frame_compatible rejects routed as in the JAX decoder:
   on the numpy host path exactly those frame_uses_rext_tools flags, on
   the hybrid device path the rest (here explicit RDPCM: all hybrid);
10. 10- and 12-bit 4:2:0: decodes tests/data/ld4k_main10.bin (3840x2160
   HEVC Main 10, IDR + 8 P frames) through decode_stream_native(data,
   device="cuda"), counters zeroed just before: every frame MD5-equal to
   manifest_torch.json (uint16 pictures), no host frame, K1 = 2 a frame,
   K2 = 2 a P frame, K3 = 3 a frame, K4 = 2; then the runs check of
   phase 8 on it; then the six small 10/12-bit vectors (HBD), MD5-equal,
   their refused frames routed as in step 9 (TU-level chroma QP offsets:
   hybrid); then K1 into
   int16 tables, K2, K3 and K4 on that stream's own inputs, each exact
   against its plain version and timed as in step 3;
11. decodes gop1080p through the GOP-sharded decoder
   (decode_stream_native(..., gop_devices=["cuda:0"] * 4): one closed
   GOP per entry, a CUDA stream each), counters zeroed before: all 96
   frames MD5-equal to manifest_big.json, 16 GOPs, K4 = 32 and K1/K2/K3
   equal to decode_all's in phase 8; its wall beside one decoder's
   through the same entry point;
12. 4:2:2, 4:4:4 and monochrome: decodes tests/data/ld4k_422_10b.bin
   (3840x2160 HEVC Main 4:2:2 10, IDR + 8 P frames) through
   decode_stream_native(data, device="cuda"), counters zeroed just
   before: every frame MD5-equal to manifest_torch.json, no host frame,
   K1 = 1 a frame and K2 = 1 a P frame (the tile table is luma's; chroma
   MC reads the chroma DPB stacks in plain torch), K3 = 3 a frame, K4 =
   2; then the runs check of phase 8 on it, with the C++-packed
   blob of its 8 P frames held byte-identical to numpy's; then the 31
   small 4:2:2 / 4:4:4 / monochrome vectors, counters zeroed before
   each: MD5-equal, refused frames routed as in step 9 (all of them
   cross-component prediction: host), K4 launched once a plane group for
   every
   device frame with intra TUs; then K3 on that stream's decoded IDR
   (chroma CTBs 32 wide, 64 tall) and K4 on its Cb|Cr group (BW 32, BH
   64; the critical path also with the old columns BH wide), on a 4:4:4
   and on a monochrome IDR, each exact against its plain version and
   timed as in step 3, and mc_chroma_dense timed on its first P frame
   beside its bound;
13. the hybrid device path (device_decode.reconstruct_frame_device):
   decodes tests/data/ld4k_422_10b_cqo.bin (3840x2160 HEVC Main 4:2:2
   10 with CU chroma QP offsets, IDR + 8 P frames: the frame program
   refuses every frame) through decode_stream_native(data,
   device="cuda"), counters zeroed just before: every frame MD5-equal to
   manifest_torch.json, every frame hybrid and none on the host path, K1
   = 1 a frame (the insert; the tile table is luma's at 4:2:2), K3 = 3 a
   frame, K2 = K4 = K5 = 0; logs its wall and fps; then the hybrid
   stages (dense MC, residuals, intra levels, loop filters, insert) on
   its IDR and first P frame, each timed by CUDA events and the host
   clock; K3 on that P frame's luma and Cb planes as the hybrid path
   feeds it, exact against sao_ctb_plain and timed as in step 3; the
   numpy reference (the host path) on the first two frames, timed and
   MD5-checked; then the 13 small vectors with refused frames (REFUSED),
   MD5-equal, with their hybrid and host frame counts: 20 and 21;
14. the push API (api.new_decoder(device="cuda"), push_data, decode,
   get_next_picture): ld4k_light pushed in 64 KiB pieces, pts = piece
   index, counters zeroed just before: every frame MD5-equal to
   manifest_big.json, each with the pts of the push that completed its
   first slice (worked out from the bytes), no host frame, K1 = 66, K2 =
   64, K3 = 99, K4 = 2, its wall beside phase 4's; then p_hash_sei and
   rxt_cqo (hybrid frames) pushed in 997-byte pieces: MD5-equal, every
   SEI picture hash checked and passed, no warning;
15. parallel.gop_parallel.decode_gop_parallel on gop1080p with
   backend="workers", workers=4, devices=["cuda:0"] (four spawned
   processes on this card, one segment a task): all 96 frames MD5-equal,
   16 segments, K4 = 32 and K1-K3 equal to phase 11's, summed over the
   workers' stats; its wall beside phase 11's GOP decoder and one
   decoder; then backend=None on rxt_cqo twice over, which the GOP
   decoder refuses: route "workers", every frame MD5-equal, its 8 hybrid
   frames counted;
16. backend.reconstruct_frame_device on the card, from the pre-filter
   planes (numpy reference, loop filters off) of the IDRs of i_deblk_sao
   (deblocking and SAO) and p_deblk (deblocking only): equal to the
   numpy reference's filtered frame, K3 launched 3 times and 0 times;
17. the port's encoder (libde265_tpu_torch.encoder, numpy on the host):
   it encodes a 1920x1080 stream of seeded content, an IDR and 3 P
   frames at ld4k_light's settings (qp 37, 64x64 CTBs, 16x16 CUs, a
   global-motion pan (-20, -12) qpel over two L0 references, TMVP,
   deblocking, SAO, a picture-hash SEI after each frame), logging the
   seconds of each frame; the card decodes it through
   decode_stream_native and through the push API (64 KiB pushes),
   counters zeroed just before each: every frame equal to the encoder's
   reconstruction, every SEI hash checked and passed, no warning, no
   host frame, K1 = 2 and K3 = 3 a frame, K2 = 2 a P frame, K4 = 2;
   then a 512x128 stream of 4 tile columns from the port's encoder
   through the tile-column decoder on ["cuda:0"] * 4 (every P frame as
   strips, K5 2 a strip frame), equal to its reconstruction; then
   rxt_cqo_scaling (scaling lists on the hybrid path; made by the port's
   encoder) on the card, every frame hybrid and MD5-equal to
   manifest_torch.json; then parallel.tile_mesh's step on ["cuda:0"] * 2
   and * 4 at 1920x1080 and 3840x2160 (demo inputs, one 16x16 TU per
   two blocks), equal to the CPU run (plane and int64 checksum) and
   timed by CUDA events; then utils.quality's psnr and ssim of the
   decoded 1080p frames against their sources on the card, equal to the
   CPU values;
18. the per-picture push decoder, api.new_decoder(device="cuda",
   parse="python") (every slice parsed in Python, each picture
   reconstructed on the card when it ends): ld4k_light cut to its IDR
   and 8 P frames (the Python parse of all 33 takes ~2 minutes there)
   pushed in 64 KiB pieces, a player's loop (decode() after every push),
   counters zeroed just before: every frame MD5-equal with its pts,
   pictures out before the flush, no host, hybrid or concealed frame, no
   warning, K1 = 18, K2 = 16, K3 = 27, K4 = 2; the Python parse seconds,
   the host ms of each picture's PictureStreamDecoder.prepare (checks,
   packing), the ms of its launch (CUDA events around launch, the host's
   enqueue gaps included) and the wall beside phases 14 and 4; then the
   119 small vectors and
   rxt_cqo_scaling in 997-byte pushes, MD5-equal, each with phase 13's
   hybrid and host frame counts (24 and 21 in all); then the recovery
   cases of tests/data/manifest_torch_recovery.json (the JAX decoder's
   pictures, warnings, statuses and hash checks, from
   tools/gen_torch_recovery_goldens.py; the fuzzed p_slices2 streams also
   through the default path, which hands their segment over); then the
   fuzz file id_009 (a 25-bit SPS) through both push decoders on the
   card and the per-picture one on the CPU, the SPS refused, the same
   pictures and warnings. Phases 14 and 17 fail if the default push
   decoder hands a segment of their clean streams to the per-picture
   path (stats n_python_segments);
19. the command-line tools (libde265_tpu_torch/tools/), each through its
   main(argv) in this process on "cuda" (port_tool), held to the
   manifest MD5s and to tests/data/manifest_torch_tools.json (the JAX
   tools' output, tools/gen_torch_tools_goldens.py): dec265 -o on
   ld4k_light with the counters zeroed just before (every frame
   MD5-equal to manifest_big.json, K1 66 / K2 64 / K3 99 / K4 2, its
   wall beside phase 4's); dec265 -c on the 16 vectors with hash SEI (no
   mismatch); -T 0 and -F 50 on p_temporal; --disable-deblocking,
   --disable-sao and both on seven vectors across the routes (frame
   program at 8 and 10 bits and 4:2:2, hybrid, numpy, numpy beside the
   device), every frame the JAX tool's, no K3 launch with SAO off, the
   card used; the sweep over tests/data (4 spawned workers on this
   card): no failure, and OK exactly where the JAX sweep was, plus
   SWEEP_BETTER; acceleration_speed --check --time (its lines, its CUDA
   event ms logged); sherlock on p_cif_mixed -n 2 (every layer's pixels,
   decoded with zlib, and the metadata); hdrcopy's stdout and copy on
   p_temporal; enc265's bytes, rd_curves' points (decoded on the card)
   and bjontegaard's lines on a seeded 128x96 8-frame YUV
   (tools_yuv); the phase's wall;
20. the measurement tools (libde265_tpu_torch/tools/bench*.py,
   profile_*.py) in this process on "cuda" (port_tool): tools.bench on
   ld4k_light with 3 rounds, the counters zeroed just before (its
   MD5-checked round passes; every serial round launches K1 66 / K2 64
   / K3 99 / K4 2, and the whole run 8 rounds' worth; its JSON line
   logged after "tools.bench: "; its device_busy_fps positive);
   profile_frame_stages on 4 P frames (the full
   variant's DPB and tables equal the default call's, every frame
   MD5-equal, each variant's launches per frame those of its stages);
   bench_intra_scan without and with --fori (MD5 match, equal
   pictures); bench_gop with 1 and 2 workers (every frame MD5-equal);
   bench_gop_device (decode_all on gop1080p, every output picture
   MD5-equal; no peer or device-to-device copy); bench_e2e on
   ld720p_light; bench_frontend on two streams into a temporary file;
   profile_intra; bench_full_pipeline at 4K, and at 512x256 against the
   CPU's checksum; the phase's wall.

Any failure exits non-zero. The last stdout line is the JSON
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the one before that lists each kernel with its time,
its plain version's time, its bound (the larger of its bytes over
3.35 TB/s and its operations over the card's peak rate for them) and,
for K1 and K5, the library yardstick's time; the rows of step 10 carry
the launches of the Main 10 decode, those of step 12 the launches of the
4:2:2 decode (K3, K4) or of the small vectors of that format (the 4:4:4
and monochrome K4 rows), the row of step 13 the K3 launches of the
hybrid 4K decode, the last twelve rows the launches of step 18's
ld4k_light decode, of step 19's dec265 run on it and of step 20's
tools.bench run on it, beside the times of step 3.

    python3 chip_smoke.py
"""
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
STREAM = "ld4k_light"
EXTRA = {"p_wp": "manifest_inter.json", "adv_b_wp_2ref": "manifest_adv.json",
         "b_mv": "manifest_inter.json", "b_mixed": "manifest_inter.json"}
TILE_STREAM = "p_tiles4_1080p_mv"
TILES = [("p_tiles2_mv", 2), ("p_tiles2_mv_nolf", 2), ("p_tiles3r_mv", 3),
         ("p_tiles4_mv", 4), ("p_tiles8_mv", 8), ("p_tiles8nu_mv", 8),
         (TILE_STREAM, 4)]
GOP_STREAM = "gop1080p"
# 3840x2160 10-bit 4:2:0 (HEVC Main 10), IDR + 8 P frames
# (tools/gen_main10_4k_stream.py; golden in manifest_torch.json)
MAIN10 = "ld4k_main10"
# 3840x2160 10-bit 4:2:0 low-delay B (the ldb4k_main10 benchmark cell's
# stream)
LDB = "ldb4k_main10"
# 3840x2160 10-bit 4:2:2 (HEVC Main 4:2:2 10), IDR + 8 P frames
# (tools/gen_main10_4k_stream.py --chroma-format 422)
S422 = "ld4k_422_10b"
# the committed 4:2:2, 4:4:4 and monochrome vectors: every entry of these
# manifests whose chroma_format is not 1
CHROMA_MANIFESTS = ("manifest_rext.json", "manifest_adv.json",
                    "manifest_rext_tools.json")
# 3840x2160 10-bit 4:2:2 with CU chroma QP offsets, IDR + 8 P frames, every
# frame on the hybrid device path (tools/gen_main10_4k_stream.py
# --chroma-format 422 --cqo)
S422_CQO = "ld4k_422_10b_cqo"
# the committed vectors with frames that frame_compatible refuses ->
# (manifest, hybrid frames, numpy host frames): the host frames are those
# frame_uses_rext_tools flags (cross-component prediction, implicit RDPCM,
# rotation, disabled smoothing), the hybrid ones the rest (TU-level chroma
# QP offsets, explicit RDPCM)
REFUSED = {"rxt_cqo": ("manifest_rext_tools.json", 4, 0),
           "adv_cqo_tiles": ("manifest_adv.json", 4, 0),
           "rxt_cqo_10b": ("manifest_rext_tools.json", 3, 0),
           "rxt_erdpcm": ("manifest_rext_tools.json", 3, 0),
           "rxt_erdpcm_rot_tsctx": ("manifest_rext_tools.json", 3, 0),
           "adv_erdpcm_dep": ("manifest_adv.json", 3, 0),
           "adv_ccp_tiles_444": ("manifest_adv.json", 0, 3),
           "adv_rot_tsctx_wpp": ("manifest_adv.json", 0, 1),
           "rxt_ccp_444": ("manifest_rext_tools.json", 0, 4),
           "rxt_ccp_cqo_444": ("manifest_rext_tools.json", 0, 3),
           "rxt_ccp_rot_444": ("manifest_rext_tools.json", 0, 3),
           "rxt_kitchen": ("manifest_rext_tools.json", 0, 4),
           "rxt_smooth_off": ("manifest_rext_tools.json", 0, 3)}
# the committed 4:2:0 vectors above 8 bits -> (manifest, frames that
# frame_compatible refuses: TU-level chroma QP offsets, on the hybrid path)
HBD = {"p_10bit": ("manifest_inter.json", 0),
       "rext_420_inter_12b": ("manifest_rext.json", 0),
       "rxt_cqo_10b": ("manifest_rext_tools.json", 3),
       "rxt_rice_scaling_10b": ("manifest_rext_tools.json", 0),
       "adv_cra_scaling_10b_amp": ("manifest_adv.json", 0),
       "adv_wpp_dep10_scaling": ("manifest_adv.json", 0)}
# the residual tools at 4:2:0: vector -> (manifest, frames that
# frame_compatible refuses: explicit RDPCM, on the hybrid path)
PART_B = {n: ("manifest_inter.json", 0) for n in (
    "p_tskip", "p_tqbypass", "i_tskip_nxn", "p_pcm", "p_pcm_nolf",
    "p_scaling")}
PART_B.update({n: ("manifest_adv.json", 0) for n in (
    "adv_lossless_tskip_partial", "adv_rice_tiles", "adv_tiles_lossless",
    "adv_dep_pcm_strong", "adv_ltr_tsa_scaling")})
PART_B.update({"adv_erdpcm_dep": ("manifest_adv.json", 3),
               "rxt_erdpcm": ("manifest_rext_tools.json", 3),
               "rxt_erdpcm_rot_tsctx": ("manifest_rext_tools.json", 3)})

# phase 17: the port's encoder. A 1080p stream at ld4k_light's settings
# (tools/gen_bench_stream.py --light), an IDR and 3 P frames, hash SEI on
ENC_W, ENC_H, ENC_FRAMES = 1920, 1080, 4
ENC_SETTINGS = dict(qp=37, inter_mode="gmv", global_mv=(-20, -12),
                    inter_residual=True, log2_ctb=6, cu_log2=4, num_ref_l0=2,
                    temporal_mvp=True, disable_deblocking=False, sao=True,
                    write_hash_sei=True)
# a small stream of 4 tile columns (p_tiles4_mv's settings in one row)
ENC_TILED = (512, 128, dict(qp=30, inter_mode="mv", inter_residual=True,
                            tiles=(4, 1), log2_ctb=6, cu_log2=4,
                            num_ref_l0=2, temporal_mvp=True,
                            disable_deblocking=False, sao=True))
# rxt_cqo_scaling: every frame hybrid (tools/gen_torch_hybrid_scaling_stream.py)
SCALING_HYBRID = "rxt_cqo_scaling"
# phase 18: ld4k_light cut to its first pictures (IDR + 8 P): the Python
# parse of all 33 takes ~2 minutes on the card's host (PERF.md section 5)
PUSH_PYTHON_FRAMES = 9
# phase 18: a fuzz file whose SPS codes 25-bit luma samples
DEEP_SPS = "id_009_intra_104x72_q26_flip2"
# phase 18: the 119 small vectors of these manifests (and rxt_cqo_scaling)
SMALL_MANIFESTS = ("manifest.json", "manifest_inter.json",
                   "manifest_rext.json", "manifest_rext_tools.json",
                   "manifest_adv.json")
# parallel.tile_mesh shapes (H, W) and tile counts
MESH_SHAPES = ((1080, 1920), (2160, 3840))
MESH_TILES = (2, 4)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and int32
# operations/s on the CUDA cores (64 int32 lanes per SM and clock, half
# the 67 TFLOP/s float32 rate; a multiply-add counts 2)
HBM_BPS = 3.35e12
INT32_OPS = 33.5e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def graph_ms(fn, reps):
    """(device ms a call, outputs) of `reps` calls of fn() replayed from a
    CUDA graph: the kernel's time without the host's enqueue of each call
    (the outputs hold what the timed replay computed)."""
    from libde265_tpu_torch.time_frames import graph_ms as gms
    return gms(fn, reps)


def cuda_time(fn, reps, warmup=1):
    """Mean milliseconds per call of fn() (CUDA events), after warmup."""
    from libde265_tpu_torch.profile_frames import cuda_ms
    for _ in range(warmup):
        fn()
    return cuda_ms(fn, reps)


def max_abs_err(xs, ys):
    import torch
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(xs, ys))


def require_equal(name, xs, ys):
    import torch
    for i, (x, y) in enumerate(zip(xs, ys)):
        if x.shape != y.shape or not torch.equal(x, y):
            bad = (x != y).nonzero()
            fail(f"{name}: kernel != plain on output {i}: "
                 f"{bad.shape[0]} samples differ, first at "
                 f"{bad[0].tolist() if bad.numel() else None}")


def bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the int32 operations over the CUDA-core rate."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def parse(name):
    from libde265_tpu_torch.api import _parse
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    return data, _parse(data)


def idr_inputs(plans, dev):
    """(cfg, packed IDR tensors on dev) of a stream's first frame."""
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    cfg = replace(stream_cfg(plans, plans[0].sps), skip_mc=True)
    t = pack_frame(plans[0], cfg, {})
    return cfg, plan_from_numpy(t, dev)


def k1_library(table, padded, slot, T):
    """K1's function as one PyTorch call, the yardstick of K1: a strided
    copy_ of the padded planes' tiles into the slot's rows viewed as
    (nty_p, ntx, P, T, T), and a zero_ of the ROWPAD rows. The port never
    calls it."""
    P, Hp, Wp = padded.shape
    nty, ntx = (Hp - T + 4) // 4, (Wp - T + 4) // 4
    nty_p = -(-nty // 8) * 8
    rows = table[slot * nty_p * ntx:(slot + 1) * nty_p * ntx] \
        .view(nty_p, ntx, P, T, T)
    rows[:nty].copy_(padded.as_strided((nty, ntx, P, T, T),
                                       (4 * Wp, 4, Hp * Wp, 1, Wp)))
    rows[nty:].zero_()
    return table


def k5_library(py, pc, dt):
    """K5's function (both tables) as K1's yardstick does it, over the
    stack of R frames."""
    import torch
    out = []
    for padded, T in ((py[:, None], 16), (pc, 8)):
        R, P, Hp, Wp = padded.shape
        nty, ntx = (Hp - T + 4) // 4, (Wp - T + 4) // 4
        nty_p = -(-nty // 8) * 8
        tab = torch.empty((R * nty_p * ntx, P * T * T), dtype=dt,
                          device=py.device)
        v = tab.view(R, nty_p, ntx, P, T, T)
        v[:, :nty].copy_(padded.as_strided(
            (R, nty, ntx, P, T, T), (P * Hp * Wp, 4 * Wp, 4, Hp * Wp, 1, Wp)))
        v[:, nty:].zero_()
        out.append(tab)
    return out


def check_k1(dev, rng, H=2160, W=3840, frame=None, bitdepth=8, label=""):
    """K1 against update_tile_table_plain into an 8-slot table of random
    rows (uint8 at 8 bits, int16 above): seeded random planes, or the
    decoded (Y, Cb, Cr) int16 planes of `frame`."""
    import torch
    from libde265_tpu_torch.ops.kernels import mc_tables as k
    from libde265_tpu_torch.ops.mc_tile import pad_plane
    from libde265_tpu_torch.packing import (PAD_C, PAD_Y, REF_SLOTS,
                                            n_tiles_c, n_tiles_y)
    dt = torch.uint8 if bitdepth == 8 else torch.int16
    res = []
    for T, P, (h, w), pad, (nty, ntx) in (
            (16, 1, (H, W), PAD_Y, n_tiles_y(H, W)),
            (8, 2, (H // 2, W // 2), PAD_C, n_tiles_c(H // 2, W // 2))):
        if frame is None:
            planes = torch.as_tensor(rng.randint(0, 1 << bitdepth,
                                                 (P, h, w)),
                                     dtype=torch.int16, device=dev)
        else:
            planes = torch.stack(frame[:1] if P == 1 else frame[1:])
        padded = pad_plane(planes, pad).contiguous()
        init = torch.as_tensor(
            rng.randint(0, 1 << bitdepth, (REF_SLOTS * nty * ntx,
                                           P * T * T)),
            dtype=dt, device=dev)
        got, want = init.clone(), init.clone()
        k.update_tile_table(got, padded, 3, T)
        k.update_tile_table_plain(want, padded, 3, T)
        torch.cuda.synchronize()
        require_equal(f"K1 T={T}", [got], [want])
        # timed: one call into each slot, so every call's rows are compared
        sl = iter(range(REF_SLOTS + 1))     # graph_ms' warm-up call first
        ms = graph_ms(lambda: k.update_tile_table(
            got, padded, next(sl) % REF_SLOTS, T), REF_SLOTS)[0]
        pms = cuda_time(lambda: k.update_tile_table_plain(want, padded, 5,
                                                          T), 3)
        for sl in range(REF_SLOTS):
            k.update_tile_table_plain(want, padded, sl, T)
        require_equal(f"K1 T={T}, the {REF_SLOTS} timed calls", [got],
                      [want])
        err = max_abs_err([got], [want])
        lib = init.clone()
        require_equal(f"K1 T={T} library call", [k1_library(lib, padded, 3,
                                                            T)],
                      [k.update_tile_table_plain(init.clone(), padded, 3, T)])
        lms = cuda_time(lambda: k1_library(lib, padded, 5, T), 20)
        # reads the padded planes once, writes one slot of table rows
        bnd = bound(padded.nbytes + nty * ntx * P * T * T * init
                    .element_size(), 0)
        res.append((T, err, ms, pms, bnd, lms))
        log(f"K1{label} T={T} P={P} {h}x{w} {dt}: equal; kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms, library (strided copy_ + "
            f"zero_) {lms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return res


def k3_bound(x, g, cidx):
    """K3's bound from this call's inputs: the plane read once and
    written once, the off grid and the CTB parameters it reads (sao_type,
    eo, band, sao_off, sidx, the slice table, pair_ok) once; about 12
    int32 operations a sample (neighbour compares, offset, clip)."""
    en = "sh_sao_luma" if cidx == 0 else "sh_sao_chroma"
    grids = sum(g[k].nbytes for k in ("off", "sao_type", "sao_eo",
                                      "sao_band", "sao_off", "sidx", en,
                                      "pair_ok"))
    return bound(2 * x.nbytes + grids, 12 * x.numel())


def check_k3(dev, rng, plans, tile_plans):
    """K3 (sao_ctb) against sao_ctb_plain: the first ld4k_light P frame's
    real grids (frame_grids), all three planes, and the three planes of
    strip 1 of the 1080p tile stream's first P frame (x0 = 448, xoff =
    432), over seeded random planes; timed as calls replayed from a CUDA
    graph, every timed call compared."""
    import torch
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids
    from libde265_tpu_torch.ops.kernels import sao_filter as k
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    from libde265_tpu_torch.parallel.tile_shard import HALO_Y, split_strips
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    g4k = frame_grids(plan_from_numpy(pack_frame(
        plans[1], cfg, {plans[0].frame_id: 3, plans[1].frame_id: 5}), dev),
        cfg)
    tcfg = replace(stream_cfg(tile_plans, tile_plans[0].sps), intra=(),
                   intra_C=0)
    fid_slot = {p.frame_id: i for i, p in enumerate(tile_plans)}
    tsh, trep, x0w = split_strips(tile_plans[1], tcfg, fid_slot, 4)
    gs = plan_from_numpy(dict(trep, **{kk: v[1] for kk, v in tsh.items()}),
                         dev)
    ws = gs["off"].shape[1] * 4
    cases = [(f"{STREAM} P frame", cfg, g4k, 0, (cfg.H, cfg.W)),
             (f"{TILE_STREAM} P frame strip 1", tcfg, gs,
              int(x0w[1, 0]) - HALO_Y, (tcfg.H, ws))]
    res = []
    for name, c, g, xoff, (h, w) in cases:
        for ci in range(3):
            sub = 1 if ci == 0 else 2
            x = torch.as_tensor(rng.randint(0, 256, (h // sub, w // sub)),
                                dtype=torch.int32, device=dev)
            args = (x, g, c.scfg, ci, xoff, 8)
            got = k.sao_ctb(*args)
            want = k.sao_ctb_plain(*args)
            torch.cuda.synchronize()
            what = f"{name} plane {ci}"
            require_equal(f"K3 {what}", [got], [want])
            err = max_abs_err([got], [want])
            ms, outs = graph_ms(lambda: k.sao_ctb(*args), 20)
            for i, o in enumerate(outs):
                require_equal(f"K3 {what} timed call {i}", [o], [want])
            del outs
            pms = cuda_time(lambda: k.sao_ctb_plain(*args), 3)
            bnd = k3_bound(x, g, ci)
            res.append((what, err, ms, pms, bnd))
            log(f"K3 {what} {tuple(x.shape)} (xoff {xoff}, "
                f"{int((want != x).sum())} samples changed): equal; kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")
    return res


def k2_bound(table, dims, mv, slot, pf, wts, ex, inter, outs, bi, x0=0):
    """K2's bound from this call's inputs: each distinct table row that
    an inter block gathers for a list it uses read once (neighbouring
    chroma blocks often share a tile), the grids read and the planes
    written once; 792 multiply-adds per luma block and list (h-pass 56 x
    11, v-pass 16 x 11), 280 per [Cb|Cr] block (32 x 7 + 8 x 7)."""
    import torch
    from libde265_tpu_torch.packing import n_tiles_c, n_tiles_y
    H, W = dims
    luma = table.shape[1] == 256
    T, frac, off, lo = (16, 2, 3, -14) if luma else (8, 3, 1, -7)
    (nty, ntx), (hp, wp) = ((n_tiles_y(H, W), (H, W)) if luma else
                            (n_tiles_c(H // 2, W // 2), (H // 2, W // 2)))
    n = torch.arange(mv.shape[0], device=mv.device)
    bx = (n % inter.shape[1]) * 4 + x0
    by = (n // inter.shape[1]) * 4
    if not luma:
        bx, by = bx >> 1, by >> 1
    live = inter.reshape(-1)
    use = [live, live & (pf[:, 0] * pf[:, 1] != 0)][:2 if bi else 1]
    rows = []
    for l, u in enumerate(use):
        xw = torch.clamp(bx + (mv[:, l, 0] >> frac) - off, lo, wp + 1)
        yw = torch.clamp(by + (mv[:, l, 1] >> frac) - off, lo, hp + 1)
        rows.append(((slot[:, l] * nty + ((yw + T) >> 2)) * ntx
                     + ((xw + T) >> 2))[u])
    nrows = int(torch.unique(torch.cat(rows)).numel())
    ngather = sum(int(u.sum()) for u in use)
    grids = sum(t.nbytes for t in (mv, slot, pf, wts, ex, inter)
                if t is not None)
    nbytes = nrows * table.shape[1] * table.element_size() + grids \
        + sum(o.nbytes for o in outs)
    return bound(nbytes, 2 * ngather * (792 if luma else 280))


def k2_synthetic(rng, H, W, bitdepth, dev, tables=None):
    """Seeded K2 inputs: every block bi-predictable, 70% explicitly
    weighted, a tenth of the MVs up to +-2^14 (edge clamp), 90% of the
    blocks inter; 8-slot random tables unless given."""
    import numpy as np
    import torch
    from libde265_tpu_torch.packing import n_tiles_c, n_tiles_y
    N = (H // 4) * (W // 4)
    maxv = (1 << bitdepth) - 1
    if tables is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng.randint(1 << 30)))
        dt = torch.uint8 if bitdepth == 8 else torch.int16
        tables = [torch.randint(0, maxv + 1, (8 * a * b, w), dtype=dt,
                                device=dev, generator=gen)
                  for (a, b), w in ((n_tiles_y(H, W), 256),
                                    (n_tiles_c(H // 2, W // 2), 128))]
    mv = rng.randint(-64, 64, (N, 2, 2))
    far = rng.rand(N) < 0.1
    mv[far] = rng.randint(-(1 << 14), 1 << 14, (int(far.sum()), 2, 2))
    pf = np.stack([np.ones(N), rng.randint(0, 2, N)], axis=1)
    wts = np.zeros((N, 3, 5), np.int64)
    wts[:, :, 4] = rng.randint(0, 8, (N, 3)) + 14 - bitdepth
    wts[:, :, 0] = rng.randint(-128, 128, (N, 3))
    wts[:, :, 2] = rng.randint(-128, 128, (N, 3))
    wts[:, :, 1] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
    wts[:, :, 3] = rng.randint(-maxv // 2, maxv // 2, (N, 3))
    i32 = dict(dtype=torch.int32, device=dev)
    args = (torch.as_tensor(mv, **i32), torch.as_tensor(
        rng.randint(0, 8, (N, 2)), **i32), torch.as_tensor(pf, **i32),
            torch.as_tensor(wts, **i32),
            torch.as_tensor(rng.rand(N) < 0.7, **i32),
            torch.as_tensor(rng.rand(H // 4, W // 4) < 0.9, dtype=torch.bool,
                            device=dev))
    return tables, args


def check_k2(dev, rng, plans):
    """K2 against mc_predict_plain: the first P frame of the main stream
    on random 8-slot 4K tables, the same tables under a synthetic bi +
    weighted motion field, and a 10-bit case on int16 tables."""
    import torch
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.frame_program import frame_grids, mc_inputs
    from libde265_tpu_torch.ops.kernels import mc_filter as k
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    from libde265_tpu_torch.packing import pack_frame, stream_cfg
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    H, W = cfg.H, cfg.W
    t = pack_frame(plans[1], cfg, {plans[0].frame_id: 3,
                                   plans[1].frame_id: 5})
    grids = mc_inputs(frame_grids(plan_from_numpy(t, dev), cfg), cfg)
    tables, synth = k2_synthetic(rng, H, W, 8, dev)
    small_tabs, small = k2_synthetic(rng, 72, 136, 10, dev)
    cases = [(f"{STREAM} P frame {{}}", tables, (H, W), grids, 8,
              cfg.has_bi),
             ("4K bi + weighted {}", tables, (H, W), synth, 8, True),
             ("72x136 10-bit int16 bi + weighted {}", small_tabs,
              (72, 136), small, 10, True)]
    res = []
    for name, tabs, dims, a, bd, bi in cases:
        for tab in tabs:
            what = name.format("luma" if tab.shape[1] == 256 else "Cb|Cr")
            args = (tab, dims, *a, bd, bi)
            got = k.mc_predict(*args)
            want = mc_predict_plain(*args)
            torch.cuda.synchronize()
            require_equal(f"K2 {what}", got, want)
            err = max_abs_err(got, want)
            ms, outs = graph_ms(lambda: k.mc_predict(*args), 20)
            for i, o in enumerate(outs):
                require_equal(f"K2 {what} timed call {i}", o, want)
            del outs
            pms = cuda_time(lambda: mc_predict_plain(*args), 3)
            bnd = k2_bound(tab, dims, *a, got, bi)
            nin = int(a[-1].sum())
            res.append((what, err, ms, pms, bnd))
            log(f"K2 {what} ({nin} inter blocks of {a[-1].numel()}): "
                f"equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                f"{bnd[0]:.4f} ms ({bnd[1]})")
    return res


def k5_path_inputs(dev, plans):
    """K5's inputs where the tile path gives them: the edge-padded DPB
    slots (sel_slots, R = cfg.r_act) that the last P frame of a
    tile-column stream references, after ShardedStreamDecoder has
    decoded the stream on `dev`; and the output dtype."""
    import torch
    from libde265_tpu_torch.device_stream import ShardedStreamDecoder
    from libde265_tpu_torch.ops.mc_tile import pad_refs
    from libde265_tpu_torch.parallel.tile_shard import split_strips
    ndev = plans[0].pps.num_tile_columns
    dec = ShardedStreamDecoder(plans, plans[0].sps, [dev] * ndev)
    dec.decode_all()
    _, trep, _ = split_strips(plans[-1], dec.cfg_scan, dec.slot_of, ndev)
    sel = torch.as_tensor(trep["sel_slots"], dtype=torch.int64, device=dev)
    py, pc = pad_refs(dec.dy[sel], dec.dcb[sel], dec.dcr[sel])
    return py, pc, torch.uint8 if dec.cfg.bitdepth <= 8 else torch.int16


def check_k5(dev, rng, tile_plans):
    """K5's wrapper build_tile_tables (one launch for the luma stack, one
    for the [Cb|Cr] pairs) against build_tile_tables_plain: the 1080p
    tile stream's real reference slots at the path's R, a seeded 4K stack
    of 8 frames into uint8 tables, a seeded 72x136 stack of 3 into int16
    tables."""
    import torch
    from libde265_tpu_torch.ops.kernels.mc_tables import (
        build_tile_tables, build_tile_tables_plain)
    from libde265_tpu_torch.ops.mc_tile import pad_refs

    def synthetic(H, W, R, bd):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng.randint(1 << 30)))
        return (*pad_refs(*(torch.randint(0, 1 << bd, (R, h, w),
                                          dtype=torch.int16, device=dev,
                                          generator=gen)
                            for h, w in ((H, W), (H // 2, W // 2),
                                         (H // 2, W // 2)))),
                torch.uint8 if bd == 8 else torch.int16)
    path = k5_path_inputs(dev, tile_plans)
    res = []
    for name, mk in (
            (f"{TILE_STREAM} path R={path[0].shape[0]}", lambda: path),
            ("4K R=8 uint8", lambda: synthetic(2160, 3840, 8, 8)),
            ("72x136 R=3 int16", lambda: synthetic(72, 136, 3, 10))):
        py, pc, dt = mk()
        got = build_tile_tables(py, pc, dt)
        want = build_tile_tables_plain(py, pc, dt)
        torch.cuda.synchronize()
        require_equal(f"K5 {name}", got, want)
        err = max_abs_err(got, want)
        # the 4K stack's tables are 1.4 GB a call: fewer calls kept
        ms, outs = graph_ms(lambda: build_tile_tables(py, pc, dt),
                            4 if py.shape[-1] > 2000 else 20)
        for i, o in enumerate(outs):
            require_equal(f"K5 {name} timed call {i}", o, want)
        del outs
        pms = cuda_time(lambda: build_tile_tables_plain(py, pc, dt), 3)
        require_equal(f"K5 {name} library call", k5_library(py, pc, dt),
                      want)
        lms = cuda_time(lambda: k5_library(py, pc, dt), 20)
        # reads the padded stacks once, writes both fresh tables
        bnd = bound(py.nbytes + pc.nbytes + sum(t.nbytes for t in got), 0)
        res.append((name, err, ms, pms, bnd, lms))
        log(f"K5 {name} (luma + Cb|Cr, {tuple(py.shape)} padded luma, "
            f"{sum(t.nbytes for t in got) / 1e6:.1f} MB of tables): equal; "
            f"kernel {ms:.4f} ms for both launches, plain {pms:.4f} ms, "
            f"library (strided copy_ + zero_) {lms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        del py, pc, got, want
        torch.cuda.empty_cache()
    return res


def check_k2_strip(dev, rng, plans):
    """K2 in strip form against mc_predict_plain: the real grids of the
    first P frame of the 1080p tile stream, tile columns 1 (x0 = 448) and
    2 (x0 = 960, 448 valid columns of a 512-wide strip), over seeded
    random tables of cfg.r_act slots."""
    import torch
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.ops.kernels import mc_filter as k
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    from libde265_tpu_torch.packing import n_tiles_c, n_tiles_y, stream_cfg
    from libde265_tpu_torch.parallel.tile_shard import (split_strips,
                                                        strip_geometry,
                                                        strip_mc_inputs)
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    H, W, ndev = cfg.H, cfg.W, plans[0].pps.num_tile_columns
    fid_slot = {p.frame_id: i for i, p in enumerate(plans)}
    tsh, trep, x0w = split_strips(plans[1], cfg, fid_slot, ndev)
    Ws = strip_geometry(plans[1], ndev)[2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.randint(1 << 30)))
    tabs = [(torch.randint(0, 256, (cfg.r_act * ny * nx, w),
                           dtype=torch.uint8, device=dev, generator=gen), grp)
            for (ny, nx), w, grp in ((n_tiles_y(H, W), 256, "luma"),
                                     (n_tiles_c(H // 2, W // 2), 128,
                                      "Cb|Cr"))]
    res = []
    for d, (tab, grp) in ((d, tg) for d in (1, 2) for tg in tabs):
        x0, wd = (int(v) for v in x0w[d])
        t = plan_from_numpy(dict(trep, **{kk: v[d] for kk, v in
                                          tsh.items()}), dev)
        a = strip_mc_inputs(t, cfg, x0, Ws)
        args = (tab, (H, W), *a, 8, cfg.has_bi)
        got = k.mc_predict(*args, strip=Ws, x0=x0)
        want = mc_predict_plain(*args, strip=Ws, x0=x0)
        torch.cuda.synchronize()
        require_equal(f"K2 strip {grp}", got, want)
        err = max_abs_err(got, want)
        ms, outs = graph_ms(lambda: k.mc_predict(*args, strip=Ws, x0=x0),
                            20)
        for i, o in enumerate(outs):
            require_equal(f"K2 strip {grp} timed call {i}", o, want)
        del outs
        pms = cuda_time(lambda: mc_predict_plain(*args, strip=Ws, x0=x0), 3)
        bnd = k2_bound(tab, (H, W), *a, got, cfg.has_bi, x0)
        what = f"{TILE_STREAM} P frame strip {d} {grp}"
        res.append((what, err, ms, pms, bnd))
        log(f"K2 {what} (x0 {x0}, {wd} of {Ws} columns valid, "
            f"{int(a[-1].sum())} inter blocks of {a[-1].numel()}): equal; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} "
            f"ms ({bnd[1]})")
    return res


def k6_bound(planes, g, fcfg):
    """K6's bound from this call's inputs: in each direction every luma
    sample read once and 6 of 8 written (the p2..q2 of each edge
    window), 4 of 8 chroma samples read and 2 of 8 written (p1..q1 read,
    p0 and q0 written), the grids read once; about 16 int32 operations a
    luma sample and direction."""
    from libde265_tpu_torch.ops.kernels.deblock import GRIDS
    ny = planes[0].numel()
    nc = sum(P.numel() for P in planes[1:]) if fcfg[2] else 0
    grids = sum(g[k].nbytes for k in GRIDS)
    return bound(2 * 4 * (ny * (1 + 6 / 8) + nc * (4 / 8 + 2 / 8))
                 + grids, 2 * 16 * ny)


def check_k6(dev):
    """K6 (deblock_frame, two launches, in place) against
    deblock_frame_plain on copies of the same card tensors, every plane
    exact: the real inputs of its callers while streams decode on the
    card, the big pictures timed (20 in-place calls on one copy of the
    planes replayed from a CUDA graph: from the second call on they
    filter what the first filtered) beside the bound and the plain
    route's time (CUDA events); then small vectors and the synthetic
    cases, exact only. Returns rows (what, max_abs_err, ms, plain_ms,
    bound) of the timed cases."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_cuda import DBK_CASES, _dbk_case, _dbk_inputs
    from libde265_tpu_torch.ops.kernels import deblock as k
    res = []

    def one(what, planes, g, fcfg, bd, xoff, timed):
        want = k.deblock_frame_plain(*(P.clone() for P in planes), g, fcfg,
                                     bd, xoff)
        got = [P.clone() for P in planes]
        n = k.deblock_frame.launches
        k.deblock_frame(*got, g, fcfg, bd, xoff)
        torch.cuda.synchronize()
        if k.deblock_frame.launches != n + 2:
            fail(f"K6 {what}: {k.deblock_frame.launches - n} launches, "
                 f"want 2")
        npl = 3 if fcfg[2] else 1
        require_equal(f"K6 {what}", got[:npl], want[:npl])
        changed = [int((w != P).sum()) for w, P in zip(want, planes[:npl])]
        if not timed:
            return
        err = max_abs_err(got[:npl], want[:npl])
        ms, _ = graph_ms(lambda: k.deblock_frame(*got, g, fcfg, bd, xoff),
                         20)
        pms = cuda_time(lambda: k.deblock_frame_plain(*planes, g, fcfg, bd,
                                                      xoff), 3)
        bnd = k6_bound(planes, g, fcfg)
        res.append((what, err, ms, pms, bnd))
        log(f"K6 {what} {tuple(planes[0].shape)} ({bd} bits, xoff {xoff}, "
            f"samples changed {changed}): equal; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")

    for name, picks, kw, what in (
            (STREAM, (("frame", 0), ("frame", 1)), {}, ("IDR", "P")),
            (LDB, (("frame", 1),), {}, ("B",)),
            (GOP_STREAM, (("frame", 0),), {}, ("IDR",)),
            (TILE_STREAM, (("strip", 1),),
             {"tile_devices": ["cuda:0"] * 4}, ("P frame strip 1",))):
        got = _dbk_inputs(name, picks, **kw)
        for key, w in zip(picks, what):
            one(f"{name} {w}", *got[key], timed=True)
        del got
        torch.cuda.empty_cache()
    small = 0
    for name, kw in (("rext_422_filters", {}), ("rext_444_filters", {}),
                     ("rext_mono_filters", {}), ("p_pcm", {}),
                     ("p_pcm_nolf", {}), ("p_tqbypass", {}),
                     ("p_tiles_nolf", {}),
                     ("p_tiles2_mv_nolf", {"tile_devices": ["cuda:0"] * 2}),
                     ("p_mixedlf", {}), ("rxt_cqo", {})):
        for key, args in _dbk_inputs(name, 3, **kw).items():
            one(f"{name} {key}", *args, timed=False)
            small += 1
    for case in DBK_CASES:
        planes, g, fcfg = _dbk_case(*case)
        one(f"synthetic {case}",
            [torch.as_tensor(x, device=dev) for x in planes],
            {kk: torch.as_tensor(v, device=dev) for kk, v in g.items()},
            fcfg, case[4], case[5], timed=False)
    log(f"K6: {small} calls of small vectors and {len(DBK_CASES)} "
        f"synthetic cases equal to deblock_frame_plain")
    return res


def tile_frame_ms(dev, plans):
    """Device milliseconds of one P frame of the 1080p tile stream
    through the strip program, every strip on `dev` (CUDA events; the
    host split excluded, the strips' uploads included)."""
    from libde265_tpu_torch.profile_frames import tile_calls
    (_, fn, reps), = tile_calls(plans, dev)
    return cuda_time(fn, 2 * reps)


def _holes(kw, rng):
    """The same scan inputs with holes punched into a third of the
    availability rows (interior available samples made unavailable)."""
    import torch
    from libde265_tpu_torch.intra_fused import avail_spans
    av = kw["avail"].clone()
    cnt = av.sum(1).cpu().numpy()
    rows = [r for r in range(av.shape[0]) if cnt[r] >= 3 and
            rng.rand() < 0.33]
    for r in rows:
        ones = av[r].nonzero().flatten().tolist()
        av[r, ones[rng.randint(1, len(ones) - 1)]] = 0
    kw = dict(kw, avail=av.contiguous(), spans=avail_spans(av))
    nh = int(((kw["spans"] >> 18) & 1).sum())
    return kw, nh


def k4_bound(kw, nplanes):
    """K4's bound from the TUs these records reconstruct: per TU and
    plane its residual (int32) read and its samples written once, its
    4n+1 border samples and availability row read, and the records;
    about 10 int32 operations a sample (prediction, residual add, clip)
    and 4 a border sample (substitution, smoothing)."""
    import torch
    recs = kw["recs"].cpu()
    valid = ((recs >> 27) & 1) != 0
    n = 1 << torch.tensor(kw["log2s"])[((recs[valid] >> 19) & 3).long()]
    samples = int((n * n).sum()) * nplanes
    border = int((4 * n + 1).sum()) * nplanes
    nbytes = 2 * 4 * samples + (4 + 1) * border + recs.nbytes \
        + sum(r.nbytes for r in kw["rowgs"])
    return bound(nbytes, 10 * samples + 4 * border)


def k4_launches(k, name, planes, kw, want, reps):
    """Mean CUDA-event ms of `reps` calls of K4's wrapper (its checks,
    band_waits and the launch), each on fresh copies of the planes (the
    copy outside the timed window) and each compared exactly with the
    plain output `want`: a wavefront race would show as a call that
    differs."""
    import torch
    ms, err = 0.0, 0
    for i in range(-1, reps):                    # -1: the warm-up
        got = [p.clone() for p in planes]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        k.intra_scan(got, **kw)
        b.record()
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        require_equal(f"K4 {name} launch {i}", got, want)
        ms += a.elapsed_time(b) if i >= 0 else 0.0
    return ms / reps, err


def k4_cases(dev, rng, cfg4k, t4k):
    """K4's cases: the intra_cif_q30 IDR (and its luma with availability
    holes), the whole 4K IDR of the main stream and the IDR of the 1080p
    tile stream, both plane groups each."""
    from libde265_tpu_torch.intra_fused import scan_groups
    cases = []
    _, cif = parse("intra_cif_q30")
    cfgc, tc = idr_inputs(cif, dev)
    for idx, kw in scan_groups(tc, cfgc):
        cases.append((f"intra_cif_q30 IDR planes {idx}", cfgc, idx, kw))
        if idx == (0,):
            kwh, nh = _holes(kw, rng)
            cases.append((f"intra_cif_q30 IDR planes {idx} + {nh} "
                          f"availability holes", cfgc, idx, kwh))
    _, tplans = parse(TILE_STREAM)
    for label, (cfg, t) in ((STREAM, (cfg4k, t4k)),
                            (TILE_STREAM, idr_inputs(tplans, dev))):
        for idx, kw in scan_groups(t, cfg):
            cases.append((f"{label} IDR planes {idx}", cfg, idx, kw))
    return cases


def check_k4(dev, rng, cases):
    """K4 against intra_scan_plain on each case (name, cfg, plane
    indices, wrapper kwargs), over seeded planes of cfg.bitdepth bits; 20
    timed launches per case, every one compared exactly with the plain
    run."""
    import torch
    from libde265_tpu_torch.ops.kernels import intra_scan as k
    from libde265_tpu_torch.profile_frames import wavefront_steps
    res = []
    for name, cfg, idx, kw in cases:
        dims = [(cfg.H, cfg.W)] + [cfg.chroma_dims] * 2
        planes = [torch.as_tensor(rng.randint(0, 1 << cfg.bitdepth,
                                              dims[i]),
                                  dtype=torch.int32, device=dev)
                  for i in idx]
        want = [p.clone() for p in planes]
        t0 = time.perf_counter()
        k.intra_scan_plain(want, **kw)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        ms, err = k4_launches(k, name, planes, kw, want, 20)
        args = (kw["recs"], kw["K"], kw["BW"])
        need = k.band_waits(*args)
        wms = cuda_time(lambda: k.band_waits(*args), 20)
        got = [p.clone() for p in planes]
        kms = cuda_time(lambda: k._launch(got, **kw, need=need), 20)
        nb = kw["recs"].shape[0] // kw["K"]
        steps, ntu = wavefront_steps(kw["recs"], kw["K"], need)
        cols = f"{kw['BH']}-row bands, {kw['BW']}-sample columns"
        if kw["BW"] != kw["BH"]:
            # the columns BH wide that the waits used before K4 took BW
            coarse, _ = wavefront_steps(kw["recs"], kw["K"], k.band_waits(
                kw["recs"], kw["K"], kw["BH"]))
            cols += f"; {coarse} TU steps with columns {kw['BH']} wide"
        bnd = k4_bound(kw, len(idx))
        res.append((name, err, ms, pms, bnd))
        log(f"K4 {name}: {ntu} TUs in {nb} bands, critical path {steps} TU "
            f"steps ({cols}); 21 wrapper calls, each equal to plain; wrapper "
            f"{ms:.4f} ms ({1e3 * ms / steps:.3f} us a step); of it, in "
            f"windows of their own, the launch without band_waits "
            f"{kms:.4f} ms and band_waits {wms:.4f} ms; plain {pms:.1f} ms (one run), bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
    return res


def check_hbd_kernels(dev, rng, plans):
    """K1, K2, K3 and K4 on the Main 10 stream's own inputs, each against
    its plain version, exact, timed as the 8-bit cases: the IDR decoded
    through the frame program into a fresh decoder's DPB; K1 writes its
    decoded planes into an 8-slot int16 table; K2 predicts the first P
    frame's real grids from the decoder's real int16 tables; K3 filters
    the decoded IDR's planes (10-bit samples) with the first P frame's
    real SAO parameters; K4 reconstructs the whole IDR, both plane groups,
    over seeded 10-bit planes. Returns the rows of K1, K2, K3, K4."""
    import torch
    from dataclasses import replace
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.frame_program import frame_grids, mc_inputs
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels import mc_filter as k2
    from libde265_tpu_torch.ops.kernels import sao_filter as k3
    from libde265_tpu_torch.ops.mc_tile import mc_predict_plain
    from libde265_tpu_torch.packing import pack_frame
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    dec.decode_plan(plans[0], 0)
    cfg, bd = dec.cfg_scan, dec.cfg.bitdepth
    s0 = dec.slot_of[plans[0].frame_id]
    frame = [p[s0] for p in (dec.dy, dec.dcb, dec.dcr)]
    r1 = check_k1(dev, rng, cfg.H, cfg.W, frame, bd, f" {MAIN10}")

    t = pack_frame(plans[1], cfg, {plans[0].frame_id: s0,
                                   plans[1].frame_id: (s0 + 1) % 8})
    g = frame_grids(plan_from_numpy(t, dev), cfg)
    grids = mc_inputs(g, cfg)
    r2 = []
    for tab in (dec.ty, dec.tc):
        what = f"{MAIN10} P frame " + ("luma" if tab.shape[1] == 256
                                       else "Cb|Cr")
        args = (tab, (cfg.H, cfg.W), *grids, bd, cfg.has_bi)
        got = k2.mc_predict(*args)
        want = mc_predict_plain(*args)
        torch.cuda.synchronize()
        require_equal(f"K2 {what}", got, want)
        ms, outs = graph_ms(lambda: k2.mc_predict(*args), 20)
        for i, o in enumerate(outs):
            require_equal(f"K2 {what} timed call {i}", o, want)
        del outs
        pms = cuda_time(lambda: mc_predict_plain(*args), 3)
        bnd = k2_bound(tab, (cfg.H, cfg.W), *grids, got, cfg.has_bi)
        r2.append((what, max_abs_err(got, want), ms, pms, bnd))
        log(f"K2 {what} ({int(grids[-1].sum())} inter blocks, {tab.dtype} "
            f"tables): equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")

    r3 = []
    for ci, P in enumerate(frame):
        x = P.to(torch.int32).contiguous()
        args = (x, g, cfg.scfg, ci, 0, bd)
        got = k3.sao_ctb(*args)
        want = k3.sao_ctb_plain(*args)
        torch.cuda.synchronize()
        what = f"{MAIN10} P frame plane {ci}"
        require_equal(f"K3 {what}", [got], [want])
        ms, outs = graph_ms(lambda: k3.sao_ctb(*args), 20)
        for i, o in enumerate(outs):
            require_equal(f"K3 {what} timed call {i}", [o], [want])
        del outs
        pms = cuda_time(lambda: k3.sao_ctb_plain(*args), 3)
        bnd = k3_bound(x, g, ci)
        r3.append((what, max_abs_err([got], [want]), ms, pms, bnd))
        log(f"K3 {what} {tuple(x.shape)} ({int((want != x).sum())} samples "
            f"changed, {bd} bits): equal; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    del dec, frame, g, grids
    torch.cuda.empty_cache()

    cfgi, ti = idr_inputs(plans, dev)
    r4 = check_k4(dev, rng, [(f"{MAIN10} IDR planes {idx}", cfgi, idx, kw)
                             for idx, kw in scan_groups(ti, cfgi)])
    return r1, r2, r3, r4


def mc_chroma_bound(refs, mv, slot, pf, wts, ex, inter, H, W, bi):
    """mc_chroma_dense's bound from this call's inputs: each distinct
    chroma reference sample that an inter block's window reads for a
    list it uses, read once from each of the two stacks, the grids read
    and the two int32 planes written once; 4 multiply-adds an output of
    each tap pass ((ch + 3) x cw and ch x cw a block, list and plane)."""
    import torch
    R, Hc, Wc = refs.shape
    subw, subh = W // Wc, H // Hc
    cw, ch = 4 // subw, 4 // subh
    n = torch.arange(mv.shape[0], device=mv.device)
    bx, by = (n % (W // 4)) * 4, (n // (W // 4)) * 4
    live = inter.reshape(-1)
    use = [live, live & (pf[:, 0] * pf[:, 1] != 0)][:2 if bi else 1]
    idx = []
    for l, u in enumerate(use):
        x0 = bx[u] // subw + ((mv[u, l, 0].long() * (2 // subw)) >> 3) - 1
        y0 = by[u] // subh + ((mv[u, l, 1].long() * (2 // subh)) >> 3) - 1
        rows = torch.clamp(y0[:, None] + torch.arange(ch + 3,
                                                      device=mv.device),
                           0, Hc - 1)
        cols = torch.clamp(x0[:, None] + torch.arange(cw + 3,
                                                      device=mv.device),
                           0, Wc - 1)
        idx.append(((slot[u, l].long()[:, None, None] * Hc
                     + rows[:, :, None]) * Wc + cols[:, None, :]).reshape(-1))
    nsamp = int(torch.unique(torch.cat(idx)).numel())
    ngather = sum(int(u.sum()) for u in use)
    grids = sum(t.nbytes for t in (mv, slot, pf, wts, ex, inter)
                if t is not None)
    nbytes = 2 * nsamp * refs.element_size() + grids + 2 * Hc * Wc * 4
    return bound(nbytes, ngather * 2 * 2 * 4 * ((ch + 3) * cw + ch * cw))


def chroma_manifest():
    """{name: (manifest file, entry)} of the committed 4:2:2, 4:4:4 and
    monochrome vectors."""
    out = {}
    for mf in CHROMA_MANIFESTS:
        with open(os.path.join(DATA, mf)) as f:
            out.update((k, (mf, v)) for k, v in json.load(f).items()
                       if v["chroma_format"] != 1)
    return out


def check_422_kernels(dev, rng, plans, small):
    """On the 4K 4:2:2 stream's own inputs: K3 on the decoded IDR's three
    planes with the first P frame's SAO parameters (chroma CTBs 32 wide
    and 64 tall), exact against sao_ctb_plain, by graph replay;
    mc_chroma_dense (plain torch, no kernel) on the first P frame's grids
    over the decoded IDR, timed; K4 on the IDR's Cb|Cr group (BW 32, BH
    64), and on both groups of a 4:4:4 IDR and the luma of a monochrome
    IDR of the small vectors `small`, as check_k4. Returns (K3 rows, K4
    rows, mc_chroma_dense ms)."""
    import torch
    from libde265_tpu_torch.convert import plan_from_numpy
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.frame_program import frame_grids, mc_inputs
    from libde265_tpu_torch.intra_fused import scan_groups
    from libde265_tpu_torch.ops.kernels import sao_filter as k3
    from libde265_tpu_torch.ops.mc_chroma import mc_chroma_dense
    from libde265_tpu_torch.packing import pack_frame
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    dec.decode_plan(plans[0], 0)
    cfg, bd = dec.cfg_scan, dec.cfg.bitdepth
    s0 = dec.slot_of[plans[0].frame_id]
    frame = [p[s0] for p in (dec.dy, dec.dcb, dec.dcr)]
    t = pack_frame(plans[1], cfg, {plans[0].frame_id: s0,
                                   plans[1].frame_id: (s0 + 1) % 8})
    g = frame_grids(plan_from_numpy(t, dev), cfg)
    r3 = []
    for ci, P in enumerate(frame):
        x = P.to(torch.int32).contiguous()
        args = (x, g, cfg.scfg, ci, 0, bd)
        got = k3.sao_ctb(*args)
        want = k3.sao_ctb_plain(*args)
        torch.cuda.synchronize()
        what = f"{S422} P frame plane {ci}"
        require_equal(f"K3 {what}", [got], [want])
        ms, outs = graph_ms(lambda: k3.sao_ctb(*args), 20)
        for i, o in enumerate(outs):
            require_equal(f"K3 {what} timed call {i}", [o], [want])
        del outs
        pms = cuda_time(lambda: k3.sao_ctb_plain(*args), 3)
        bnd = k3_bound(x, g, ci)
        r3.append((what, max_abs_err([got], [want]), ms, pms, bnd))
        log(f"K3 {what} {tuple(x.shape)} ({int((want != x).sum())} samples "
            f"changed, {bd} bits): equal; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")

    mv, slot, pf, wts, ex, inter = mc_inputs(g, cfg)
    mc_ms = cuda_time(lambda: mc_chroma_dense(
        dec.dcb, dec.dcr, mv, slot, pf, wts, ex, cfg.H, cfg.W, bd,
        bi=cfg.has_bi), 10)
    mbnd = mc_chroma_bound(dec.dcb, mv, slot, pf, wts, ex, inter, cfg.H,
                           cfg.W, cfg.has_bi)
    log(f"mc_chroma_dense (plain torch) {S422} P frame, both (2160, 1920) "
        f"chroma planes from the chroma DPB stacks: {mc_ms:.4f} ms "
        f"(CUDA events, 10 calls), bound {mbnd[0]:.4f} ms ({mbnd[1]})")
    del dec, frame, g, mv, slot, pf, wts, ex, inter
    torch.cuda.empty_cache()

    cases = []
    cfgi, ti = idr_inputs(plans, dev)
    cases += [(f"{S422} IDR planes {idx}", cfgi, idx, kw)
              for idx, kw in scan_groups(ti, cfgi) if idx == (1, 2)]
    for name in small:
        c, tt = idr_inputs(parse(name)[1], dev)
        cases += [(f"{name} IDR planes {idx}", c, idx, kw)
                  for idx, kw in scan_groups(tt, c)]
    r4 = check_k4(dev, rng, cases)
    return r3, r4, mc_ms


def frame_times(dev, plans):
    """Device milliseconds of the 4K IDR and of one P frame through
    decode_frame_device (CUDA events; packing excluded)."""
    from libde265_tpu_torch.profile_frames import frame_calls
    return [cuda_time(fn, reps) for _, fn, reps in frame_calls(plans, dev)]


def check_native_blob(plans):
    """The C++ packer's blob of eight consecutive P frames (the layout
    learned from the numpy packer, as decode_all's runs do) against
    pack_frame + pack_blob of the same frames, byte for byte."""
    import numpy as np
    from dataclasses import replace
    from libde265_tpu_torch.packing import (blob_meta, pack_blob,
                                            pack_blob_native, pack_frame,
                                            stream_cfg)
    cfg = replace(stream_cfg(plans, plans[0].sps), intra=(), intra_C=0)
    slot_map = {p.frame_id: i for i, p in enumerate(plans[:9])}
    run = plans[1:9]
    frames = [pack_frame(p, cfg, slot_map) for p in run]
    stacked = {k: np.stack([t[k] for t in frames]) for k in frames[0]}
    meta, totals = blob_meta(stacked)
    want = pack_blob(stacked, meta, totals)
    got = pack_blob_native(run, cfg, slot_map, meta, totals)
    if got is None:
        fail("pack_blob_native refused the P-frame layout")
    for dt in want:
        if got[dt].tobytes() != want[dt].tobytes():
            fail(f"native blob != numpy blob for dtype {dt}")
    return sum(a.nbytes for a in want.values())


def check_runs(name, plans, counters, dev, sync_debug=False,
               manifest="manifest_big.json"):
    """decode_all, the push path's engine (runs of frames planned ahead,
    packed as one blob by the C++ writer, uploaded once), against a
    second decoder fed frame by frame (decode_plan on each frame in
    turn), on the same plans, counters zeroed before each, after a
    warm-up decode_all: the same launches, final DPB stacks, tile
    tables and slot map, and every output picture MD5-equal to the
    manifest. With sync_debug, one more decode_all runs under
    torch.cuda.set_sync_debug_mode("warn"): every synchronising call it
    reports must be an upload (convert.py) or a download
    (DeviceStreamDecoder._download). Returns (wall decode_all s, wall
    frame by frame s, pack s, launches, intra frames, syncs reported
    under sync-debug mode or None)."""
    import inspect
    import numpy as np
    import torch
    import warnings
    from libde265_tpu_torch import telemetry
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.packing import frame_has_intra

    def run(by_frame):
        dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        if by_frame:
            for i, p in enumerate(plans):
                dec.decode_plan(p, i)
        else:
            dec.decode_all()
        torch.cuda.synchronize()
        return dec, time.perf_counter() - t0, [f.launches for f in counters]

    _, wall_warm, _ = run(False)                 # the warm-up
    telemetry.clear()
    dec, wall, ln = run(False)
    native = telemetry.totals().get("pack.native", (0, 0.0, 0))[2]
    ref, wall_ref, ln_ref = run(True)
    nfr = len(plans)
    if ln != ln_ref:
        fail(f"{name}: decode_all launches {ln} != frame by frame {ln_ref}")
    if dec.slot_of != ref.slot_of:
        fail(f"{name}: decode_all slot map != frame by frame")
    for what, a, b in zip(("dy", "dcb", "dcr", "ty", "tc"), dec.state(),
                          ref.state()):
        if not torch.equal(a, b):
            fail(f"{name}: decode_all {what} != frame by frame")
    with open(os.path.join(DATA, manifest)) as f:
        man = json.load(f)[name]
    nout = 0
    for i, p in enumerate(plans):
        if p.output_flag:
            got = [hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()
                   for a in dec.planes_of(p.frame_id)]
            if got != [man["md5"][i][c] for c in ("y", "u", "v")]:
                fail(f"{name}: decode_all frame {i} MD5 differs")
            nout += 1
    nintra = sum(frame_has_intra(p) for p in plans)
    log(f"runs {name}: {nfr} frames ({nintra} with intra), {native} "
        f"filled by the C++ writer; launches K1 {ln[0]}, K2 {ln[1]}, K3 "
        f"{ln[2]}, K4 {ln[3]}, equal to frame by frame; final state and "
        f"slot map equal; {nout} output pictures MD5-equal")
    log(f"runs {name}: decode_all {wall:.3f} s = {nfr / wall:.2f} fps "
        f"(pack {dec.pack_seconds:.3f} s; the warm-up {wall_warm:.3f} s); "
        f"frame by frame {wall_ref:.3f} s = {nfr / wall_ref:.2f} fps (pack "
        f"{ref.pack_seconds:.3f} s); parse excluded")
    syncs = None
    if sync_debug and hasattr(torch.cuda, "set_sync_debug_mode"):
        src, first = inspect.getsourcelines(DeviceStreamDecoder._download)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # the mode's own notice ("a prototype feature ...") is not a sync
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        sites = {}
        for w in syncs:
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
        hidden = {k: n for k, n in sites.items()
                  if not (k.startswith("convert.py:") or (
                      k.startswith("device_stream.py:") and
                      first <= int(k.split(":")[1]) < first + len(src)))}
        log(f"runs {name} under sync-debug mode: {len(syncs)} host syncs "
            f"reported, by site {sites}")
        if hidden:
            fail(f"{name}: decode_all synchronised outside the uploads and "
                 f"downloads: {hidden}")
        syncs = len(syncs)
    return wall, wall_ref, dec.pack_seconds, ln, nintra, syncs


def hybrid_stages(dev, plans, frames=(0, 1)):
    """The hybrid path's stages (device_decode.STAGES, then the DPB
    insert) on frames `frames` of `plans`, decoded in order by one
    DeviceStreamDecoder: each frame once whole (a warm-up, not inserted),
    then stage by stage, each stage timed by CUDA events and by the host
    clock between synchronisations. The insert is timed into the slot
    that the frame's decode takes next, before decode_plan decodes it
    there. The inputs of the luma and Cb K3 launches of the last frame
    are kept. Returns (decoder, {frame: [(stage, event ms, wall ms)]},
    [(sao_ctb args), ...])."""
    import torch
    from libde265_tpu_torch.device_decode import (STAGES, new_planes,
                                                  reconstruct_frame_device)
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    from libde265_tpu_torch.ops import filters_fused
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    bd = dec.cfg.bitdepth
    times, k3_args = {}, []
    real_sao = filters_fused.sao_ctb

    def keep_sao(*a):
        if a[3] < 2:
            k3_args.append(a)
        return real_sao(*a)

    def timed(fn):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3

    for i in range(max(frames) + 1):
        plan = plans[i]
        if i in frames:
            needed = dec.ref_fids(plan)
            for rf in needed:
                dec._ensure_in_stack(rf, i, needed)
            _, ms, wall = timed(lambda: reconstruct_frame_device(plan, dec))
            rows = [("whole frame, first call", ms, wall)]
            planes = new_planes(plan, dev)
            if i == max(frames):
                filters_fused.sao_ctb = keep_sao
            try:
                for name, stage in STAGES:
                    planes, ms, wall = timed(
                        lambda: stage(plan, dec, planes, bd))
                    rows.append((name, ms, wall))
            finally:
                filters_fused.sao_ctb = real_sao
            slot, _ = dec._next_slot(dec.slot_fid, needed, dec.last_use)
            _, ms, wall = timed(lambda: dec._do_insert(planes, slot))
            rows.append(("insert", ms, wall))
            times[i] = rows
        dec.decode_plan(plan, i)
    return dec, times, k3_args


def check_k3_hybrid(args_list):
    """K3 (sao_ctb) on planes of the hybrid path, with the grids that
    ops/filters_fused.apply_filters_fused uploaded for them, against
    sao_ctb_plain, timed as check_k3. Returns its rows."""
    import torch
    from libde265_tpu_torch.ops.kernels import sao_filter as k
    res = []
    for args in args_list:
        x, ci = args[0], args[3]
        got = k.sao_ctb(*args)
        want = k.sao_ctb_plain(*args)
        torch.cuda.synchronize()
        what = f"{S422_CQO} P frame plane {ci} (hybrid path)"
        require_equal(f"K3 {what}", [got], [want])
        ms, outs = graph_ms(lambda: k.sao_ctb(*args), 20)
        for i, o in enumerate(outs):
            require_equal(f"K3 {what} timed call {i}", [o], [want])
        del outs
        pms = cuda_time(lambda: k.sao_ctb_plain(*args), 3)
        bnd = k3_bound(x, args[1], ci)
        res.append((what, max_abs_err([got], [want]), ms, pms, bnd))
        log(f"K3 {what} {tuple(x.shape)} ({int((want != x).sum())} samples "
            f"changed, {args[5]} bits): equal; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return res


def numpy_frames(dec, plans, name, manifest, n=2):
    """The numpy reference (reconstruct.reconstruct_frame, the host path)
    on the first n frames of `plans`, its references the hybrid decoder
    `dec`'s pictures: seconds a frame, each frame MD5-checked. Run last:
    it materializes the plans' TURecords."""
    import numpy as np
    from libde265_tpu_torch.device_stream import _HostRefShim
    from libde265_tpu_torch.reconstruct import reconstruct_frame
    with open(os.path.join(DATA, manifest)) as f:
        man = json.load(f)[name]
    secs = []
    for i, plan in enumerate(plans[:n]):
        t0 = time.perf_counter()
        planes = reconstruct_frame(plan, dpb_images=_HostRefShim(dec))
        secs.append(time.perf_counter() - t0)
        got = [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
               for p in planes]
        if got != [man["md5"][i][c] for c in ("y", "u", "v")]:
            fail(f"{name} frame {i}: the numpy reference's MD5 differs")
    return secs


def expected_pts(data, chunk):
    """The pts each picture of `data` should carry when the stream is
    pushed in `chunk`-byte pieces with pts = piece index: that of the push
    that completes the NAL of its first slice (the NAL parser emits a NAL
    once the next start code has arrived; the last one at flush, with
    the last push's pts), in decode order. Worked out from the bytes,
    independently of the decoder."""
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\x00\x00\x01", i + 3)
    last = (len(data) - 1) // chunk
    out = []
    for k, j in enumerate(starts):
        t = (data[j + 3] >> 1) & 0x3F
        if t < 32 and data[j + 5] & 0x80:      # first_slice_segment_in_pic
            out.append((starts[k + 1] + 2) // chunk
                       if k + 1 < len(starts) else last)
    return out


def sei_hash_count(data):
    """Decoded-picture-hash SEI messages in `data`."""
    from libde265_tpu_torch.bitstream.nal import split_annexb
    from libde265_tpu_torch.bitstream.sei import parse_sei
    return sum(m.picture_hash is not None
               for u in split_annexb(data)
               if u.header.nal_unit_type in (39, 40)
               for m in parse_sei(u.data))


def push_decode(data, chunk, device):
    """Push `data` into new_decoder(device) in `chunk`-byte pieces, pts =
    piece index; decode until decode() returns False, then drain the
    pictures. Every stream given here is clean: fails if a segment went
    to the per-picture path (stats n_python_segments). Returns
    (pictures, decoder, host wall s)."""
    from libde265_tpu_torch import api
    t0 = time.perf_counter()
    dec = api.new_decoder(device=device)
    for i in range(0, len(data), chunk):
        api.push_data(dec, data[i:i + chunk], pts=i // chunk)
    api.flush_data(dec)
    pics = []
    while True:
        more = api.decode(dec)
        while True:
            p = api.get_next_picture(dec)
            if p is None:
                break
            pics.append(p)
        if not more:
            break
    wall = time.perf_counter() - t0
    if dec.stats["n_python_segments"]:
        fail(f"push API: {dec.stats['n_python_segments']} of "
             f"{dec.stats['n_segments']} segments of a clean stream handed "
             f"to the per-picture path")
    return pics, dec, wall


def warnings_of(dec):
    out = []
    while True:
        w = dec.get_warning()
        if w is None:
            return out
        out.append(w.name)


def md5_check(name, frames, manifest, repeat=1):
    """frames: the (poc, yuv bytes) of an 8-bit 4:2:0 stream that is the
    manifest's `repeat` times over; every frame's per-plane MD5 equal to
    the manifest's, in its order."""
    with open(os.path.join(DATA, manifest)) as f:
        man = json.load(f)[name]
    want = man["md5"] * repeat
    if len(frames) != len(want):
        fail(f"{name} x{repeat}: {len(frames)} frames, want {len(want)}")
    ny = man["w"] * man["h"]
    nc = ny // 4
    for i, (poc, buf) in enumerate(frames):
        got = [hashlib.md5(b).hexdigest() for b in
               (buf[:ny], buf[ny:ny + nc], buf[ny + nc:])]
        if len(buf) != ny + 2 * nc or got != [want[i][c] for c in "yuv"]:
            fail(f"{name} x{repeat} frame {i} (poc {poc}): MD5 differs")


def check_backend_filters(dev, counters):
    """backend.reconstruct_frame_device on the card: the pre-filter
    planes (the numpy reference with its loop filters switched off) of
    the IDRs of i_deblk_sao (deblocking and SAO) and p_deblk (deblocking
    only), counters zeroed before each; the result must equal the numpy
    reference's filtered frame, with K3 launched once a plane where SAO
    is on and never where it is off. Returns [(name, K3 launches)]."""
    import torch
    from libde265_tpu_torch.backend import reconstruct_frame_device
    from libde265_tpu_torch.reconstruct import reconstruct_frame
    out = []
    for name, sao in (("i_deblk_sao", True), ("p_deblk", False)):
        plan = parse(name)[1][0]
        full = reconstruct_frame(plan)
        os.environ["DE265_DISABLE_DEBLOCK"] = "1"
        os.environ["DE265_DISABLE_SAO"] = "1"
        try:
            pre = reconstruct_frame(plan)
        finally:
            del os.environ["DE265_DISABLE_DEBLOCK"]
            del os.environ["DE265_DISABLE_SAO"]
        plan.planes = [torch.as_tensor(p.astype("int32")).to(dev)
                       for p in pre]
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0
        got = reconstruct_frame_device(plan)
        torch.cuda.synchronize()
        k3 = counters[2].launches
        require_equal(f"reconstruct_frame_device {name}",
                      [g.cpu() for g in got],
                      [torch.as_tensor(p.astype("int32")) for p in full])
        if got[0].device.type != "cuda" or k3 != (3 if sao else 0):
            fail(f"reconstruct_frame_device {name}: on {got[0].device}, "
                 f"K3 launched {k3} times, want {3 if sao else 0}")
        out.append((name, k3))
    return out


def encoder_frames(n, w, h, seed=1080):
    """Seeded 8-bit 4:2:0 content for the encoder: make_frames_light's
    field (tools/gen_bench_stream.py) with a 16x16-blocky texture drawn
    from `seed`, panned by (3, 5) samples a frame (the (-20, -12) qpel
    global MV), a flat box of h / 4 moving over it, and slow chroma
    waves."""
    import numpy as np
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    tex = np.kron(rng.randint(0, 24, (h // 16 + 1, w // 16 + 1)),
                  np.ones((16, 16), np.int64))[:h, :w]
    base = np.clip(80 + 70 * np.sin(gx / 37.0) * np.cos(gy / 29.0) + tex,
                   0, 255).astype(np.uint8)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    frames = []
    for t in range(n):
        y = np.roll(base, (t * 3, t * 5), (0, 1)).copy()
        b = h // 4
        bx, by = (31 * t) % (w - b), (17 * t) % (h - b)
        y[by:by + b, bx:bx + b] = 210
        u = np.clip(128 + 50 * np.sin(cx / 41.0 + t * .4), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 50 * np.cos(cy / 33.0 - t * .2), 0,
                    255).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def port_encode(w, h, settings, frames):
    """Encode `frames` with the port's encoder. Returns (stream, the
    encoder's reconstruction of each frame, host seconds of each)."""
    from libde265_tpu_torch.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=w, height=h, **settings))
    recon, secs = [], []
    encode_frame = enc._encode_frame

    def encode_and_keep(*a):
        t0 = time.perf_counter()
        out = encode_frame(*a)
        secs.append(time.perf_counter() - t0)
        recon.append([p.copy() for p in enc.recon])
        return out
    enc._encode_frame = encode_and_keep
    return enc.encode(frames), recon, secs


def recon_check(name, pics, recon):
    """Every picture equal to the encoder's reconstruction, MD5 for MD5."""
    import numpy as np
    if len(pics) != len(recon):
        fail(f"{name}: {len(pics)} pictures, the encoder made {len(recon)}")
    for i, (pic, rec) in enumerate(zip(pics, recon)):
        got = [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
               for p in pic.planes]
        want = [hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
                for p in rec]
        if got != want:
            fail(f"{name} frame {i} (poc {pic.poc}): MD5 {got} != the "
                 f"encoder's reconstruction {want}")


def check_tile_mesh():
    """parallel.tile_mesh's step on ["cuda:0"] * tiles against the same
    step on the CPU (plane and checksum exact), and its time on the card
    (CUDA events, inputs on the card). Returns [(H, W, tiles, n_tu, ms,
    checksum)]."""
    import torch
    from libde265_tpu_torch.parallel import tile_mesh as T
    out = []
    for H, W in MESH_SHAPES:
        for tiles in MESH_TILES:
            n_tu = (H // 16) * (W // 16) // 2 // tiles * tiles
            inp = T.demo_inputs(H, W, tiles, n_tu)
            step = T.make_tile_recon_step(["cuda:0"] * tiles, H, W, tiles,
                                          n_tu)
            card = [torch.as_tensor(a, device="cuda") for a in inp]
            got = step(*card)
            want = T.make_tile_recon_step(["cpu"] * tiles, H, W, tiles,
                                          n_tu)(*inp)
            require_equal(f"tile_mesh {W}x{H} on {tiles} x cuda:0",
                          [g.cpu() for g in got], list(want))
            if not got[0].is_cuda:
                fail(f"tile_mesh {W}x{H}: plane on {got[0].device}")
            ms = cuda_time(lambda: step(*card), 20)
            out.append((H, W, tiles, n_tu, ms, int(want[1])))
    return out


def check_quality(pics, frames):
    """utils.quality's psnr and ssim of each decoded picture's planes
    against the source, on the card and on the CPU: equal to 1e-12.
    Returns the card's [(psnr Y, U, V, ssim Y)] per picture."""
    import numpy as np
    import torch
    from libde265_tpu_torch.utils import quality as Q
    out = []
    for i, (pic, src) in enumerate(zip(pics, frames)):
        row = []
        for c, (p, s_) in enumerate(zip(pic.planes, src)):
            a = torch.as_tensor(np.asarray(p), device="cuda")
            b = torch.as_tensor(s_, device="cuda")
            vals = [(Q.psnr(a, b), Q.psnr(p, s_))]
            if c == 0:
                vals.append((Q.ssim(a, b), Q.ssim(p, s_)))
            for got, want in vals:
                if not abs(got - want) <= 1e-12 * abs(want):
                    fail(f"quality frame {i} plane {c}: card {got!r}, CPU "
                         f"{want!r}")
            row += [v[0] for v in vals]
        out.append(row)
    return out


def small_vectors():
    """The committed small vectors: every entry of the five small
    manifests, then rxt_cqo_scaling -> manifest."""
    out = {}
    for man in SMALL_MANIFESTS:
        with open(os.path.join(DATA, man)) as f:
            out.update((name, man) for name in json.load(f))
    out[SCALING_HYBRID] = "manifest_torch.json"
    return out


def manifest_md5s(name, manifest):
    """The manifest's per-frame MD5 lists (luma only for monochrome)."""
    with open(os.path.join(DATA, manifest)) as f:
        man = json.load(f)[name]
    return [[m[c] for c in ("y", "u", "v") if c in m] for m in man["md5"]]


def first_pictures(data, n):
    """`data` cut before the NAL of the (n+1)-th picture's first slice."""
    i = data.find(b"\x00\x00\x01")
    k = 0
    while i >= 0:
        t = (data[i + 3] >> 1) & 0x3F
        if t < 32 and data[i + 5] & 0x80:       # first_slice_segment_in_pic
            if k == n:
                return data[:i - (i > 0 and data[i - 1] == 0)]
            k += 1
        i = data.find(b"\x00\x00\x01", i + 3)
    return data


def live_push(data, chunk, device, parse):
    """A player's loop: push `data` in `chunk`-byte pieces (pts = piece
    index), after each push decode() until it asks for input and take
    the pictures that come out; then flush and decode to the end.
    Returns (pictures, decoder, host wall s, pictures out before the
    flush)."""
    from libde265_tpu_torch import api
    t0 = time.perf_counter()
    dec = api.new_decoder(device=device, parse=parse)
    pics = []

    def drain():
        while True:
            more = api.decode(dec)
            while (p := api.get_next_picture(dec)) is not None:
                pics.append(p)
            if not more:
                return
    for i in range(0, len(data), chunk):
        api.push_data(dec, data[i:i + chunk], pts=i // chunk)
        drain()
    early = len(pics)
    api.flush_data(dec)
    drain()
    return pics, dec, time.perf_counter() - t0, early


def check_push_python(counters, data, wall14, wall4, device="cuda"):
    """Phase 18: the per-picture push decoder (parse="python") on the
    card. Returns its launches on the main path."""
    import numpy as np
    import torch
    from libde265_tpu_torch.device_stream import PictureStreamDecoder
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from gen_torch_recovery_goldens import OUT as GOLDEN, build_stream, \
        trace

    # per picture: the host ms of prepare (checks, caps, packing; host
    # clock) and the launch ms (CUDA events around launch: its uploads
    # and launches on the card's clock, the host's enqueue gaps between
    # them included; the device may still run after it)
    data = first_pictures(data, PUSH_PYTHON_FRAMES)
    prep_ms, events = [], []
    orig = PictureStreamDecoder.prepare, PictureStreamDecoder.launch

    def prepare(self, view):
        t = time.perf_counter()
        try:
            return orig[0](self, view)
        finally:
            prep_ms.append(1e3 * (time.perf_counter() - t))

    def launch(self, job):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        orig[1](self, job)
        b.record()
        events.append((a, b))
    PictureStreamDecoder.prepare, PictureStreamDecoder.launch = \
        prepare, launch
    try:
        chunk = 64 * 1024
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0
        pics, dec, wall, early = live_push(data, chunk, device, "python")
        torch.cuda.synchronize()
        ln = [f.launches for f in counters]
        ms = [a.elapsed_time(b) for a, b in events]
    finally:
        PictureStreamDecoder.prepare, PictureStreamDecoder.launch = orig
    want = manifest_md5s(STREAM, "manifest_big.json")[:PUSH_PYTHON_FRAMES]
    want_pts = expected_pts(data, chunk)
    if len(pics) != len(want):
        fail(f"parse=python {STREAM}: {len(pics)} pictures, want "
             f"{len(want)}")
    for i, pic in enumerate(pics):
        if [pic.plane_md5(c) for c in range(3)] != want[i]:
            fail(f"parse=python {STREAM} frame {i} (poc {pic.poc}): MD5 "
                 f"differs")
        if pic.pts != want_pts[pic.plan.frame_id]:
            fail(f"parse=python {STREAM} frame {i}: pts {pic.pts}, want "
                 f"{want_pts[pic.plan.frame_id]}")
    st, ws = dec.stats, warnings_of(dec)
    n = len(pics)
    log(f"parse=python {STREAM} (its first {n} pictures): {n} frames "
        f"MD5-equal to manifest_big.json with their pts, {early} out "
        f"before the flush "
        f"({len(data)} bytes in pushes of {chunk}); Python parse "
        f"{st['parse_s']:.3f} s; host prepare ms a picture IDR "
        f"{prep_ms[0]:.3f}, P min {min(prep_ms[1:]):.3f} / median "
        f"{float(np.median(prep_ms[1:])):.3f} / max {max(prep_ms[1:]):.3f}; "
        f"launch ms a picture (CUDA events around launch, enqueue gaps "
        f"included) IDR {ms[0]:.3f}, P min {min(ms[1:]):.3f} / "
        f"median {float(np.median(ms[1:])):.3f} / max {max(ms[1:]):.3f}; "
        f"n_host_frames {st['n_host_frames']}, n_hybrid_frames "
        f"{st['n_hybrid_frames']}, n_concealed_frames "
        f"{st['n_concealed_frames']}; warnings {ws}; launches K1 {ln[0]}, "
        f"K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]}, K5 {ln[4]}; wall {wall:.3f} "
        f"s = {n / wall:.2f} fps (phase 14, the segment path: "
        f"{wall14:.3f} s; phase 4, decode_stream_native: {wall4:.3f} s)")
    if ln != [2 * n, 2 * (n - 1), 3 * n, 2, 0] or st["n_host_frames"] \
            or st["n_hybrid_frames"] or st["n_concealed_frames"] or ws \
            or not early:
        fail(f"parse=python {STREAM}: launches {ln} (want K1 {2 * n}, K2 "
             f"{2 * (n - 1)}, K3 {3 * n}, K4 2), host "
             f"{st['n_host_frames']}, hybrid {st['n_hybrid_frames']}, "
             f"concealed {st['n_concealed_frames']}, warnings {ws}, "
             f"{early} pictures before the flush")

    # the small vectors: MD5s, and phase 13's routes
    t0 = time.perf_counter()
    tot, parse_s, nfr = [0, 0], 0.0, 0
    for name, manifest in small_vectors().items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            sdata = f.read()
        spics, sdec, _, _ = live_push(sdata, 997, device, "python")
        want = manifest_md5s(name, manifest)
        got = [[p.plane_md5(c) for c in range(len(w))]
               for p, w in zip(spics, want)]
        if len(spics) != len(want) or got != want:
            fail(f"parse=python {name}: {len(spics)} pictures, MD5s "
                 f"differ from {manifest}")
        s_ = sdec.stats
        route = (s_["n_hybrid_frames"], s_["n_host_frames"])
        want_route = (len(want), 0) if name == SCALING_HYBRID else \
            REFUSED.get(name, (None, 0, 0))[1:]
        if route != want_route or s_["n_concealed_frames"] \
                or warnings_of(sdec):
            fail(f"parse=python {name}: hybrid / host frames {route}, want "
                 f"{want_route}; {s_['n_concealed_frames']} concealed")
        tot[0] += route[0]
        tot[1] += route[1]
        parse_s += s_["parse_s"]
        nfr += len(spics)
    swall = time.perf_counter() - t0
    log(f"parse=python: {len(small_vectors())} small vectors, {nfr} "
        f"frames MD5-equal; {tot[0]} hybrid and {tot[1]} numpy host frames "
        f"(phase 13's: 20 + 4 of {SCALING_HYBRID}, 21); Python parse "
        f"{parse_s:.3f} s of {swall:.3f} s wall")
    if tot != [24, 21]:
        fail(f"parse=python small vectors routed {tot}, want [24, 21]")

    # the recovery cases against the JAX decoder's goldens
    from libde265_tpu_torch import api
    with open(GOLDEN) as f:
        gold = json.load(f)
    for name, e in gold.items():
        r = e["recipe"]
        sdata = build_stream(r)
        if hashlib.md5(sdata).hexdigest() != e["bytes_md5"]:
            fail(f"recovery {name}: the rebuilt stream differs")
        got, sdec = trace(api, sdata, r["chunk"], r.get("dpb_size"),
                          device=device, parse="python")
        if json.loads(json.dumps(got)) != e["jax"]:
            fail(f"recovery {name} (parse=python): differs from the JAX "
                 f"decoder's golden: {got['warnings']} / "
                 f"{e['jax']['warnings']}")
        line = (f"recovery {name}: {len(got['pictures'])} pictures, "
                f"warnings {got['warnings']}, statuses "
                f"{sorted({s for s, _ in got['steps']})} as the JAX "
                f"decoder's; host {sdec.stats['n_host_frames']}, concealed "
                f"{sdec.stats['n_concealed_frames']}")
        if r["native"]:
            nat, ndec = trace(api, sdata, r["chunk"], device=device)
            if any(json.loads(json.dumps(nat[k])) != e["jax"][k]
                   for k in ("pictures", "warnings", "hash_checks")) \
                    or ndec.stats["n_python_segments"] != 1:
                fail(f"recovery {name} (default path): differs from the "
                     f"golden, or {ndec.stats['n_python_segments']} "
                     f"python segments")
            line += "; the default path hands its segment over, the same"
        log(line)

    # the fuzz file with a 25-bit luma SPS: both push decoders refuse the
    # SPS (SPS_HEADER_INVALID) on the card as on the CPU, and carry on
    from libde265_tpu_torch.errors import Warning as W
    with open(os.path.join(DATA, DEEP_SPS + ".bin"), "rb") as f:
        sdata = f.read()
    recs = {}
    for dev, parse in ((device, "python"), (device, "native"),
                       ("cpu", "python")):
        got, sdec = trace(api, sdata, 997, device=dev, parse=parse)
        recs[dev, parse] = {k: json.loads(json.dumps(got[k]))
                            for k in ("pictures", "warnings", "hash_checks")}
    ref = recs["cpu", "python"]
    if any(r != ref for r in recs.values()) \
            or ref["warnings"][:1] != [int(W.SPS_HEADER_INVALID)]:
        fail(f"{DEEP_SPS}: {recs}")
    log(f"{DEEP_SPS}: the 25-bit SPS refused by both push decoders, "
        f"{len(ref['pictures'])} pictures, warnings {ref['warnings']} "
        f"(the CPU's)")
    return ln


def port_tool(name, argv):
    """(exit code, stdout, wall s) of libde265_tpu_torch.tools.<name>
    .main(argv) in this process; the environment (the kill-switches a
    tool sets) is restored after it. Whatever the tool raises leaves
    this script."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"libde265_tpu_torch.tools.{name}")
    env = dict(os.environ)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv))
    finally:
        os.environ.clear()
        os.environ.update(env)
    return rc, buf.getvalue(), time.perf_counter() - t0


def check_tools(counters, wall4):
    """Phase 19: the command-line tools (libde265_tpu_torch/tools/), each
    through its main(argv) on "cuda", held to the dec265 MD5s and to
    tests/data/manifest_torch_tools.json (the JAX tools' output, from
    tools/gen_torch_tools_goldens.py). Returns dec265's launches on the
    main path."""
    import tempfile
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from gen_torch_tools_goldens import (
        OUT as GOLDEN, SWEEP_BETTER, SWITCHES, TEMPORAL, filter0_pixels,
        frame_md5s, html_images, n_frames, pixel_md5, tools_yuv)
    with open(GOLDEN) as f:
        gold = json.load(f)
    tp = time.perf_counter()
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    dev = ["--device", "cuda"]

    def stream(name):
        return os.path.join(DATA, name + ".bin")

    def zero():
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0

    def dec265(name, argv):
        """(per-frame MD5s of dec265's -o output, launches, wall)."""
        out = os.path.join(tmp, "out.yuv")
        zero()
        rc, so, wall = port_tool("dec265", [*argv, *dev, "-o", out,
                                            stream(name)])
        torch.cuda.synchronize()
        ln = [f.launches for f in counters]
        if rc != 0:
            fail(f"dec265 {argv} {name}: exit {rc}: {so}")
        with open(out, "rb") as f:
            yuv = f.read()
        os.remove(out)
        return frame_md5s(yuv, n_frames(so)), ln, wall, so

    # ---- the main path: dec265 -o on the 4K stream, counters zeroed
    out = os.path.join(tmp, "ld4k.yuv")
    zero()
    rc, so, wall = port_tool("dec265", [*dev, "-o", out, stream(STREAM)])
    torch.cuda.synchronize()
    ln = [f.launches for f in counters]
    if rc != 0:
        fail(f"dec265 {STREAM}: exit {rc}")
    want = manifest_md5s(STREAM, "manifest_big.json")
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        big = json.load(f)[STREAM]
    H, W = big["h"], big["w"]
    with open(out, "rb") as f:
        for i, w in enumerate(want):
            frame = f.read(H * W * 3 // 2)
            got = [hashlib.md5(p).hexdigest() for p in (
                frame[:H * W], frame[H * W:H * W * 5 // 4],
                frame[H * W * 5 // 4:])]
            if got != w:
                fail(f"dec265 {STREAM} frame {i}: MD5 differs")
        if f.read(1):
            fail(f"dec265 {STREAM}: more frames than the manifest")
    os.remove(out)
    n = len(want)
    log(f"dec265 -o {STREAM}: {n} frames MD5-equal to manifest_big.json; "
        f"its line: {so.strip()}; wall {wall:.3f} s = {n / wall:.2f} fps "
        f"with the YUV written (phase 4, decode_stream_native: {wall4:.3f} "
        f"s); launches K1 {ln[0]}, K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]}, K5 "
        f"{ln[4]}")
    if ln != [2 * n, 2 * (n - 1), 3 * n, 2, 0]:
        fail(f"dec265 {STREAM}: launches {ln}, want K1 {2 * n}, K2 "
             f"{2 * (n - 1)}, K3 {3 * n}, K4 2")

    # ---- -c on every vector with hash SEI (the segment push decoder)
    t0 = time.perf_counter()
    for name in gold["hash_sei"]:
        zero()
        rc, so, _ = port_tool("dec265", ["-c", *dev, stream(name)])
        if rc != 0 or "MISMATCH" in so:
            fail(f"dec265 -c {name}: exit {rc}: {so}")
    log(f"dec265 -c: {len(gold['hash_sei'])} vectors with hash SEI, no "
        f"mismatch ({time.perf_counter() - t0:.3f} s)")

    # ---- -T / -F (the per-picture push decoder)
    for name, cases in gold["temporal"].items():
        for k, want in cases.items():
            argv = TEMPORAL[1][k]
            got, _, _, _ = dec265(name, argv)
            if got != want:
                fail(f"dec265 {argv} {name}: frames differ from the JAX "
                     f"tool's")
    log(f"dec265 -T / -F on {', '.join(gold['temporal'])}: equal to the JAX "
        f"tool's")

    # ---- the kill-switches on vectors that span the routes
    t0 = time.perf_counter()
    for name, by in gold["killswitch"].items():
        for k, want in by.items():
            got, kl, _, _ = dec265(name, SWITCHES[k])
            if got != want:
                fail(f"dec265 {' '.join(SWITCHES[k])} {name}: frames "
                     f"differ from the JAX tool's")
            if k != "deblock" and kl[2]:
                fail(f"dec265 {' '.join(SWITCHES[k])} {name}: K3 launched "
                     f"{kl[2]} times")
            if name != "rxt_ccp_444" and not kl[0]:
                fail(f"dec265 {' '.join(SWITCHES[k])} {name}: no frame on "
                     f"the card")
    log(f"dec265 --disable-deblocking / --disable-sao / both: "
        f"{len(gold['killswitch'])} vectors ({', '.join(gold['killswitch'])})"
        f" equal to the JAX tool's, no K3 launch with SAO off "
        f"({time.perf_counter() - t0:.3f} s)")

    # ---- the sweep over tests/data: every stream the JAX tool decoded
    # decodes, and only SWEEP_BETTER beside them
    rc, so, wall = port_tool("decodestreams", [DATA, *dev])
    named = dict(ln_.split(": ", 1) for ln_ in so.splitlines()
                 if ": " in ln_)
    ds = gold["decodestreams"]
    ok = {k for k, v in named.items() if v == "OK"}
    want_ok = (set(named) - set(ds["not_ok"])) | set(SWEEP_BETTER)
    summary = so.strip().splitlines()[-1]
    log(f"decodestreams {DATA}: {summary}, {len(ok)} OK and "
        f"{sum(v.startswith('FUZZ') for v in named.values())} fuzzed files "
        f"failed as allowed (the JAX tool's: {ds['summary']}, {ds['ok']} "
        f"OK; here also {', '.join(SWEEP_BETTER)}); wall {wall:.3f} s, "
        f"4 spawned workers on this card")
    if rc != 0 or summary != ds["summary"] or ok != want_ok:
        fail(f"decodestreams: exit {rc}, {summary}; OK here only "
             f"{sorted(ok - want_ok)}, not OK here {sorted(want_ok - ok)}: "
             f"{[named.get(k) for k in sorted(want_ok - ok)][:5]}")

    # ---- acceleration_speed --check --time
    rc, so, wall = port_tool("acceleration_speed", ["--check", "--time",
                                                    *dev])
    lines = so.splitlines()
    want = [f"transform {n}x{n}: OK" for n in (4, 8, 16, 32)] + \
        [f"mc_luma {n}x{n}: OK" for n in (8, 16, 32, 64)] + \
        ["all kernels verified against scalar reference"]
    if rc != 0 or [ln_ for ln_ in lines if not ln_.startswith("  ")] \
            != want:
        fail(f"acceleration_speed: exit {rc}: {so}")
    log("acceleration_speed --check --time: every check OK; "
        + "; ".join(ln_.strip() for ln_ in lines if ln_.startswith("  ")))

    # ---- sherlock
    sg = gold["sherlock"]
    html = os.path.join(tmp, "sherlock.html")
    rc, so, _ = port_tool("sherlock", [stream(sg["stream"]), "-o", html,
                                       "-n", str(sg["frames"]), *dev])
    with open(html) as f:
        imgs, meta = html_images(f.read())
    # the PNGs decoded with zlib (the card's machine has no imaging
    # library)
    got = [{k: pixel_md5(filter0_pixels(v)) for k, v in d.items()}
           for d in imgs]
    if rc != 0 or meta != sg["meta"] or got != sg["pixels"]:
        fail(f"sherlock {sg['stream']}: exit {rc}, pixels or metadata "
             f"differ from the JAX tool's")
    log(f"sherlock {sg['stream']} -n {sg['frames']}: every layer's pixels "
        f"(decoded with zlib) and the metadata equal the JAX tool's")

    # ---- hdrcopy
    hg = gold["hdrcopy"]
    cp = os.path.join(tmp, "ps.bin")
    rc, so, _ = port_tool("hdrcopy", [stream(hg["stream"]), "--slices",
                                      "--copy", cp])
    with open(cp, "rb") as f:
        copied = f.read()
    if rc != 0 or hashlib.md5(so.replace(cp, "OUT").encode()).hexdigest() \
            != hg["stdout_md5"] or hashlib.md5(copied).hexdigest() \
            != hg["copy_md5"]:
        fail(f"hdrcopy {hg['stream']}: differs from the JAX tool's")

    # ---- enc265, rd_curves (decoded on the card), bjontegaard on the
    # seeded YUV
    sd = gold["seeded"]
    yuv = os.path.join(tmp, "in.yuv")
    with open(yuv, "wb") as f:
        f.write(tools_yuv(sd["seed"], sd["w"], sd["h"], sd["frames"]))
    geo = ["-w", str(sd["w"]), "-h", str(sd["h"])]
    enc = os.path.join(tmp, "enc.bin")
    rc, so, ewall = port_tool("enc265", ["-i", yuv, "-o", enc, *geo, "-f",
                                         str(sd["frames"]),
                                         *sd["enc265"]["args"]])
    with open(enc, "rb") as f:
        if rc != 0 or so != sd["enc265"]["stdout"] or \
                hashlib.md5(f.read()).hexdigest() != sd["enc265"]["md5"]:
            fail("enc265: bytes or line differ from the JAX tool's")
    paths = []
    zero()
    for k in ("a", "b"):
        path = os.path.join(tmp, f"curve_{k}.json")
        rc, so, _ = port_tool("rd_curves", [
            "-i", yuv, *geo, "-f", str(sd["rd_curves"][k]["frames"]),
            "--qps", sd["rd_curves"]["qps"], "-o", path, *dev])
        with open(path) as f:
            if rc != 0 or json.load(f) != sd["rd_curves"][k]["points"]:
                fail(f"rd_curves {k}: points differ from the JAX tool's")
        paths.append(path)
    torch.cuda.synchronize()
    rl = [f.launches for f in counters]
    rc, so, _ = port_tool("bjontegaard", paths)
    if rc != 0 or so != sd["bjontegaard"]:
        fail(f"bjontegaard: {so!r} != {sd['bjontegaard']!r}")
    if not rl[0] or not rl[3]:
        fail(f"rd_curves: launches {rl}: its decodes did not run on the "
             f"card")
    log(f"hdrcopy {hg['stream']}, enc265 ({ewall:.3f} s), rd_curves "
        f"(launches K1 {rl[0]}, K2 {rl[1]}, K3 {rl[2]}, K4 {rl[3]}) and "
        f"bjontegaard ({so.strip()!r}) on the seeded {sd['w']}x{sd['h']} "
        f"{sd['frames']}-frame YUV: equal to the JAX tools'")
    tmpdir.cleanup()
    log(f"phase 19 (the command-line tools): {time.perf_counter() - tp:.3f}"
        f" s")
    return ln


def check_bench_tools(counters):
    """Phase 20: the measurement tools (libde265_tpu_torch/tools/bench*.py,
    profile_*.py), each through its main(argv) on "cuda". Returns
    tools.bench's launches over its whole run on the main stream."""
    import tempfile
    import torch
    from libde265_tpu_torch.tools.bench import JSON_KEYS
    tp = time.perf_counter()
    dev = ["--device", "cuda"]

    def zero():
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0

    def last_json(name, rc, so):
        if rc != 0:
            fail(f"{name}: exit {rc}: {so[-2000:]}")
        return json.loads(so.strip().splitlines()[-1])

    # ---- tools.bench on the main stream, counters zeroed just before
    per_round = [66, 64, 99, 2, 0]
    zero()
    rc, so, wall = port_tool("bench", ["--stream", STREAM, "--rounds", "3",
                                       *dev])
    torch.cuda.synchronize()
    ln = [f.launches for f in counters]
    res = last_json("tools.bench", rc, so)
    log(f"tools.bench: {so.strip().splitlines()[-1]}")
    rounds = res["round_launches"]["serial"]
    # verification + 3 serial + the IDR and P loops of the resident
    # diagnostics (3 rounds) + the profiled round of device_busy
    want = [8 * n for n in per_round]
    log(f"tools.bench {STREAM}: wall {wall:.3f} s; value {res['value']:.3f}"
        f" fps, serial sustained {res['serial_sustained_fps']:.3f} fps, "
        f"device only (event window, launches included) "
        f"{res['device_only_fps']:.3f} fps, device busy "
        f"{res['device_busy_fps']:.3f} fps (busy share "
        f"{res['device_busy_share']:.4f}); {len(rounds)} timed rounds "
        f"each K1-K5 {rounds[0]}; the run's launches {ln}")
    if set(res) != set(JSON_KEYS) or any(r != per_round for r in rounds) \
            or len(rounds) != 3 or ln != want \
            or not res["device_busy_fps"] > 0:
        fail(f"tools.bench: keys {sorted(res)}, round launches {rounds} "
             f"(want {per_round} each), the run's {ln} (want {want})")

    # ---- profile_frame_stages on 4 P frames
    rc, so, wall = port_tool("profile_frame_stages", [
        STREAM, "--frames", "4", "--rounds", "3", *dev])
    res = last_json("profile_frame_stages", rc, so)
    rows = {r["variant"]: r for r in map(json.loads,
                                         so.strip().splitlines()[:-1])}
    # K1-K5 launches per P frame of each variant's stages
    want = {"none": [0, 0, 0, 0, 0], "tables": [2, 0, 0, 0, 0],
            "mc_luma": [0, 1, 0, 0, 0], "mc": [0, 2, 0, 0, 0],
            "mc_res": [0, 2, 0, 0, 0], "mc_res_dbk": [0, 2, 0, 0, 0],
            "full": [2, 2, 3, 0, 0]}
    log("profile_frame_stages (4 4K P frames, CUDA events): " + "; ".join(
        f"{k} {r['ms_per_frame']:.3f} ms" for k, r in rows.items())
        + f"; attribution {res['attribution_ms']}; full == default "
        f"{res['full_equals_default']} ({wall:.3f} s)")
    if not res["full_equals_default"] or res["default_md5_mismatch_pocs"] \
            or {k: r["launches_per_frame"] for k, r in rows.items()} != want:
        fail(f"profile_frame_stages: {res}, launches "
             f"{ {k: r['launches_per_frame'] for k, r in rows.items()} }")

    # ---- bench_intra_scan, K4 and the wavefront levels
    for argv in ([], ["--fori"]):
        rc, so, wall = port_tool("bench_intra_scan", [*argv, *dev])
        log(f"bench_intra_scan {' '.join(argv)}: "
            + "; ".join(so.strip().splitlines()[1:]) + f" ({wall:.3f} s)")
        if rc != 0 or "MD5 MATCH" not in so or (
                argv and "pictures EQUAL" not in so):
            fail(f"bench_intra_scan {argv}: exit {rc}: {so}")

    # ---- bench_gop with 1 and 2 spawned workers on this card
    rc, so, wall = port_tool("bench_gop", ["--workers", "1,2", *dev])
    res = last_json("bench_gop", rc, so)
    log(f"bench_gop {GOP_STREAM} (every frame MD5-equal to "
        f"manifest_big.json in each run): " + "; ".join(
            f"{r['workers']} workers {r['fps']:.3f} fps, efficiency "
            f"{r['efficiency']:.3f}" for r in res["results"])
        + f" ({wall:.3f} s)")

    # ---- bench_gop_device: the GOP stream through decode_all, the GOP
    # decoder's copies
    rc, so, wall = port_tool("bench_gop_device", dev)
    res = last_json("bench_gop_device", rc, so)
    log(f"bench_gop_device: {json.dumps(res)} ({wall:.3f} s)")
    if res["peer_copies"] or res["d2d_copies"]:
        fail(f"bench_gop_device: {res['peer_copies']} peer and "
             f"{res['d2d_copies']} device-to-device copies, want 0")

    # ---- bench_e2e, bench_frontend, profile_intra
    rc, so, wall = port_tool("bench_e2e", [
        os.path.join(DATA, "ld720p_light.bin"), "device", "3", *dev])
    if rc != 0:
        fail(f"bench_e2e: exit {rc}: {so}")
    log(f"bench_e2e: {so.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fe.jsonl")
        rc, so, wall = port_tool("bench_frontend", [
            out, "--streams", "ld720p_light,ld4k_light", "--reps", "1"])
        with open(out) as f:
            rows = [json.loads(ln_) for ln_ in f]
    log("bench_frontend: " + "; ".join(
        f"{r['stream']} threads {r['threads']}: parse {r['parse_fps']:.1f}"
        f", extract {r['extract_fps']:.1f} fps" for r in rows))
    if rc != 0 or so or len(rows) != 4:
        fail(f"bench_frontend: exit {rc}, stdout {so!r}, {len(rows)} rows")
    rc, so, wall = port_tool("profile_intra", ["--reps", "1", *dev])
    log(f"profile_intra: {json.dumps(last_json('profile_intra', rc, so))} "
        f"({wall:.3f} s)")

    # ---- bench_full_pipeline at 4K, and small against the CPU
    rc, so, wall = port_tool("bench_full_pipeline", ["--iters", "5", *dev])
    log(f"bench_full_pipeline: "
        f"{json.dumps(last_json('bench_full_pipeline', rc, so))}")
    small = ["--iters", "2", "--height", "256", "--width", "512"]
    got = last_json("bench_full_pipeline", *port_tool(
        "bench_full_pipeline", [*small, *dev])[:2])["checksum"]
    ref = last_json("bench_full_pipeline", *port_tool(
        "bench_full_pipeline", [*small, "--device", "cpu"])[:2])["checksum"]
    log(f"bench_full_pipeline 512x256: checksum {got} on the card, {ref} "
        f"on the CPU")
    if got != ref:
        fail("bench_full_pipeline: the card's checksum differs from the "
             "CPU's")
    log(f"phase 20 (the measurement tools): {time.perf_counter() - tp:.3f}"
        f" s")
    return ln


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA "
             "card")
    if not os.path.isdir(os.path.join(REPO, "libde265_tpu_torch")):
        fail("libde265_tpu_torch/ not found beside chip_smoke.py: run from "
             "a checkout of the repository")
    sys.path.insert(0, REPO)
    import numpy as np
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}")

    from libde265_tpu_torch import _build
    t0 = time.perf_counter()
    _build.ensure_frontend()
    t1 = time.perf_counter()
    _build.kernels_lib()
    t2 = time.perf_counter()
    log(f"build: native front end {t1 - t0:.2f} s, CUDA kernels "
        f"{t2 - t1:.2f} s (nvcc {_build.build_seconds} s)")

    rng = np.random.RandomState(2160)
    data, plans = parse(STREAM)
    cfg4k, t4k = idr_inputs(plans, dev)
    k1 = check_k1(dev, rng)
    k2 = check_k2(dev, rng, plans)
    torch.cuda.empty_cache()
    _, tile_plans = parse(TILE_STREAM)
    k3 = check_k3(dev, rng, plans, tile_plans)
    torch.cuda.empty_cache()
    k4 = check_k4(dev, rng, k4_cases(dev, rng, cfg4k, t4k))
    del t4k
    torch.cuda.empty_cache()
    k5 = check_k5(dev, rng, tile_plans)
    k2s = check_k2_strip(dev, rng, tile_plans)
    torch.cuda.empty_cache()
    k6 = check_k6(dev)
    torch.cuda.empty_cache()

    # ---- the main path, through the user's entry point
    from libde265_tpu_torch.api import decode_stream_native
    from libde265_tpu_torch.ops.kernels.intra_scan import intra_scan
    from libde265_tpu_torch.ops.kernels.mc_filter import mc_predict
    from libde265_tpu_torch.ops.kernels.mc_tables import (build_tile_tables,
                                                          update_tile_table)
    from libde265_tpu_torch.ops.kernels.sao_filter import sao_ctb
    from libde265_tpu_torch.ops.kernels.deblock import deblock_frame
    counters = (update_tile_table, mc_predict, sao_ctb, intra_scan,
                build_tile_tables)

    def decode(name, data, manifest, **kw):
        """Decode on the card with every launch count zeroed just before;
        MD5-check every frame. Returns (pics, stats, launches, wall s);
        K6's launches are the stats' "k6_launches"."""
        torch.cuda.synchronize()
        for f in counters + (deblock_frame,):
            f.launches = 0
        st = {}
        t0 = time.perf_counter()
        pics = decode_stream_native(data, device="cuda", stats=st, **kw)
        wall = time.perf_counter() - t0
        launches = [f.launches for f in counters]
        st["k6_launches"] = deblock_frame.launches
        with open(os.path.join(DATA, manifest)) as f:
            man = json.load(f)[name]
        if len(pics) != man["frames"]:
            fail(f"{name}: decoded {len(pics)} pictures, manifest has "
                 f"{man['frames']}")
        for i, pic in enumerate(pics):
            got = [hashlib.md5(np.ascontiguousarray(p).tobytes())
                   .hexdigest() for p in pic.planes]
            # monochrome manifests hold luma only; its chroma is empty
            want = [man["md5"][i][c] for c in ("y", "u", "v")
                    if c in man["md5"][i]]
            if len(want) == 1 and any(p.size for p in pic.planes[1:]):
                fail(f"{name} frame {i}: monochrome with chroma samples")
            if got[:len(want)] != want:
                fail(f"{name} frame {i} (poc {pic.poc}) MD5 {got} != "
                     f"{want}")
        return pics, st, launches, wall

    pics, st, launches, wall = decode(STREAM, data, "manifest_big.json")
    launches6 = st["k6_launches"]
    wall4 = wall                   # later phases reuse the name
    log(f"decode: {len(pics)} frames {pics[0].width}x{pics[0].height} "
        f"MD5-equal to manifest_big.json; n_host_frames "
        f"{st['n_host_frames']}")
    if st["n_host_frames"]:
        fail(f"{st['n_host_frames']} frames took the numpy host path")
    nfr = len(pics)
    log(f"decode: parse {st['parse_s']:.3f} s, pack {st['pack_s']:.3f} s, "
        f"device decode incl. pack and download {st['decode_s']:.3f} s; "
        f"wall {wall:.3f} s = {nfr / wall:.2f} fps, device decode "
        f"{nfr / st['decode_s']:.2f} fps")
    log(f"launches on the main path: K1 {launches[0]}, K2 {launches[1]}, "
        f"K3 {launches[2]}, K4 {launches[3]}, K6 {st['k6_launches']}")
    if launches[0] != 2 * nfr or launches[1] != 2 * (nfr - 1) \
            or launches[2] != 3 * nfr or launches[3] != 2 \
            or st["k6_launches"] != 2 * nfr:
        fail(f"kernel launches {launches}, K6 {st['k6_launches']}; want "
             f"K1 {2 * nfr}, K2 {2 * (nfr - 1)}, K3 {3 * nfr}, K4 2, K6 "
             f"{2 * nfr}")

    # ---- the weighted and bi-predicted paths
    for name, manifest in EXTRA.items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            p, s_, ln, _ = decode(name, f.read(), manifest)
        log(f"decode {name}: {len(p)} frames MD5-equal to {manifest}; "
            f"n_host_frames {s_['n_host_frames']}; launches K1 {ln[0]}, "
            f"K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]}")
        if ln[1] < 2:
            fail(f"{name}: K2 launched {ln[1]} times")

    # ---- the tile-column decoder, every strip on this card
    def decode_tiles(name, ndev, devices):
        manifest = "manifest_torch.json" if name == TILE_STREAM \
            else "manifest_inter.json"
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            p, s_, ln, wall = decode(name, f.read(), manifest,
                                     tile_devices=devices)
        nf, ns = len(p), s_["n_strip_frames"]
        nrep = nf - ns            # frames of the single-device program
        sao = 3 if p[0].plan.sps.sample_adaptive_offset_enabled_flag else 0
        # K1: 2 a frame, strip frames included (their tables are brought
        # up to date after the reassembly)
        want = [2 * nf, 2 * ndev * ns, sao * (nrep + ndev * ns), None,
                2 * ns * len(set(devices))]
        want6 = 2 * (nrep + ndev * ns)
        log(f"decode {name} ({ndev} tile columns on {devices}): {nf} "
            f"frames MD5-equal to {manifest}; n_host_frames "
            f"{s_['n_host_frames']}, strip frames {ns}; launches K1 "
            f"{ln[0]}, K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]}, K5 {ln[4]}, K6 "
            f"{s_['k6_launches']}; wall {wall:.3f} s")
        if s_["k6_launches"] != want6:
            fail(f"{name}: K6 launched {s_['k6_launches']} times, want "
                 f"{want6}")
        if s_["n_host_frames"] or ns != nf - 1:
            fail(f"{name}: {s_['n_host_frames']} host frames, {ns} of "
                 f"{nf - 1} P frames as strips")
        if [ln[i] for i in (0, 1, 2, 4)] != [want[i] for i in (0, 1, 2, 4)] \
                or ln[3] < 1:
            fail(f"{name}: launches {ln}, want K1 {want[0]}, K2 {want[1]}, "
                 f"K3 {want[2]}, K4 >= 1, K5 {want[4]}")
        return p, s_, ln, wall

    tiles = {name: decode_tiles(name, ndev, ["cuda:0"] * ndev)
             for name, ndev in TILES}
    _, tst, tln, twall = tiles[TILE_STREAM]
    if tln[3] < 2:
        fail(f"{TILE_STREAM}: K4 launched {tln[3]} times, want >= 2")
    if torch.cuda.device_count() >= 2:
        decode_tiles("p_tiles2_mv", 2, ["cuda:0", "cuda:1"])
    else:
        log("tile phase: one card, so every tile column's strip ran on "
            "cuda:0, one after another (no cross-card halo copy)")

    # ---- decode_all's runs against frame by frame, on the 4K stream and
    # the 1080p GOP stream
    nbytes = check_native_blob(plans)
    log(f"native packer: the blob of 8 {STREAM} P frames ({nbytes} bytes) "
        f"byte-identical to pack_frame + pack_blob")
    pl = check_runs(STREAM, plans, counters[:4], dev, sync_debug=True)
    if pl[3] != [2 * nfr, 2 * (nfr - 1), 3 * nfr, 2]:
        fail(f"runs {STREAM}: launches {pl[3]}, want K1 {2 * nfr}, K2 "
             f"{2 * (nfr - 1)}, K3 {3 * nfr}, K4 2")
    _, gop_plans = parse(GOP_STREAM)
    gl = check_runs(GOP_STREAM, gop_plans, counters[:4], dev)
    if gl[4] != 16 or gl[3][3] < 16:
        fail(f"runs {GOP_STREAM}: {gl[4]} intra frames, K4 "
             f"{gl[3][3]}; want 16 IDRs through K4")
    del gop_plans
    torch.cuda.empty_cache()

    # ---- the residual tools at 4:2:0 (transform-skip, bypass, PCM,
    # scaling lists)
    from libde265_tpu_torch.packing import (frame_compatible,
                                            frame_has_intra,
                                            frame_uses_rext_tools,
                                            stream_cfg)
    def routes(name, s_, refused):
        """The frames frame_compatible refuses: the numpy host path for
        those frame_uses_rext_tools flags, the hybrid path for the rest."""
        splans = parse(name)[1]
        rejected = sum(not frame_compatible(q) for q in splans)
        rext = sum(frame_uses_rext_tools(q) for q in splans)
        got = (s_["n_hybrid_frames"], s_["n_host_frames"])
        if rejected != refused or got != (rejected - rext, rext):
            fail(f"{name}: {got[0]} hybrid and {got[1]} host frames; "
                 f"frame_compatible refuses {rejected} (want {refused}), "
                 f"frame_uses_rext_tools flags {rext}")
        return f"n_hybrid_frames {got[0]}, n_host_frames {got[1]}"

    for name, (manifest, refused) in PART_B.items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            bdata = f.read()
        p, s_, ln, _ = decode(name, bdata, manifest)
        log(f"decode {name}: {len(p)} frames MD5-equal to {manifest}; "
            f"{routes(name, s_, refused)}; launches K1 {ln[0]}, K2 {ln[1]}, "
            f"K3 {ln[2]}, K4 {ln[3]}")
        if ln[3] < 1:
            fail(f"{name}: K4 launched {ln[3]} times")

    # ---- 10- and 12-bit 4:2:0: the 4K Main 10 stream through the user's
    # entry point, then decode_all's runs, then the small vectors
    data10, plans10 = parse(MAIN10)
    p10, st10, ln10, wall10 = decode(MAIN10, data10, "manifest_torch.json")
    n10 = len(p10)
    log(f"decode {MAIN10}: {n10} frames {p10[0].width}x{p10[0].height} "
        f"{p10[0].planes[0].dtype} MD5-equal to manifest_torch.json; "
        f"n_host_frames {st10['n_host_frames']}; parse "
        f"{st10['parse_s']:.3f} s, pack {st10['pack_s']:.3f} s, device "
        f"decode incl. pack and download {st10['decode_s']:.3f} s; wall "
        f"{wall10:.3f} s = {n10 / wall10:.2f} fps; launches K1 {ln10[0]}, "
        f"K2 {ln10[1]}, K3 {ln10[2]}, K4 {ln10[3]}")
    want10 = [2 * n10, 2 * (n10 - 1), 3 * n10, 2]
    if st10["n_host_frames"] or ln10[:4] != want10:
        fail(f"{MAIN10}: {st10['n_host_frames']} host frames, launches "
             f"{ln10[:4]}, want 0 and {want10}")
    pl10 = check_runs(MAIN10, plans10, counters[:4], dev,
                      manifest="manifest_torch.json")
    if pl10[3] != want10:
        fail(f"runs {MAIN10}: launches {pl10[3]}, want {want10}")
    for name, (manifest, refused) in HBD.items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            p, s_, ln, _ = decode(name, f.read(), manifest)
        log(f"decode {name}: {len(p)} frames at {p[0].plan.sps.BitDepthY} "
            f"bits MD5-equal to {manifest}; {routes(name, s_, refused)}; "
            f"launches K1 {ln[0]}, K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]}")
    k1h, k2h, k3h, k4h = check_hbd_kernels(dev, rng, plans10)
    del plans10
    torch.cuda.empty_cache()

    # ---- the GOP-sharded decoder: gop1080p, one GOP per entry of
    # ["cuda:0"] * 4 (a CUDA stream each), against decode_all's launches
    with open(os.path.join(DATA, GOP_STREAM + ".bin"), "rb") as f:
        gdata = f.read()
    gp, gst, gln, gwall = decode(GOP_STREAM, gdata, "manifest_big.json",
                                 gop_devices=["cuda:0"] * 4)
    if gst["n_gops"] != 16 or gst["n_host_frames"] \
            or gln[:4] != list(gl[3]) or gln[3] != 32:
        fail(f"GOP decoder on {GOP_STREAM}: {gst['n_gops']} GOPs, "
             f"{gst['n_host_frames']} host frames, launches {gln[:4]}; "
             f"want 16, 0 and decode_all's {gl[3]} with K4 32")
    _, sst, _, swall = decode(GOP_STREAM, gdata, "manifest_big.json")
    log(f"GOP decoder {GOP_STREAM}: {len(gp)} frames in {gst['n_gops']} "
        f"GOPs on ['cuda:0'] * 4 MD5-equal to manifest_big.json; launches "
        f"K1 {gln[0]}, K2 {gln[1]}, K3 {gln[2]}, K4 {gln[3]}, equal to "
        f"decode_all's; wall {gwall:.3f} s = {len(gp) / gwall:.2f} fps "
        f"(parse {gst['parse_s']:.3f} s, decode incl. pack and download "
        f"{gst['decode_s']:.3f} s); decode_stream_native with one decoder "
        f"{swall:.3f} s = {len(gp) / swall:.2f} fps (parse "
        f"{sst['parse_s']:.3f} s, decode {sst['decode_s']:.3f} s); phase "
        f"8, parse excluded: decode_all {gl[0]:.3f} s, frame by frame "
        f"{gl[1]:.3f} s")

    # ---- 4:2:2, 4:4:4 and monochrome: the 4K Main 4:2:2 10 stream
    # through the user's entry point, then decode_all's runs, then the small
    # vectors, then K3, K4 and mc_chroma_dense on their own inputs
    d422, plans422 = parse(S422)
    p422, st422, ln422, wall422 = decode(S422, d422, "manifest_torch.json")
    n422 = len(p422)
    log(f"decode {S422}: {n422} frames {p422[0].width}x{p422[0].height} "
        f"chroma {p422[0].planes[1].shape} {p422[0].planes[0].dtype} "
        f"MD5-equal to manifest_torch.json; n_host_frames "
        f"{st422['n_host_frames']}; parse {st422['parse_s']:.3f} s, pack "
        f"{st422['pack_s']:.3f} s, device decode incl. pack and download "
        f"{st422['decode_s']:.3f} s; wall {wall422:.3f} s = "
        f"{n422 / wall422:.2f} fps; launches K1 {ln422[0]}, K2 "
        f"{ln422[1]}, K3 {ln422[2]}, K4 {ln422[3]}")
    want422 = [n422, n422 - 1, 3 * n422, 2]
    if p422[0].chroma_format != 2 or st422["n_host_frames"] \
            or ln422[:4] != want422:
        fail(f"{S422}: chroma format {p422[0].chroma_format}, "
             f"{st422['n_host_frames']} host frames, launches {ln422[:4]}, "
             f"want 2, 0 and {want422}")
    nbytes = check_native_blob(plans422)
    log(f"native packer: the blob of 8 {S422} P frames ({nbytes} bytes) "
        f"byte-identical to pack_frame + pack_blob")
    pl422 = check_runs(S422, plans422, counters[:4], dev,
                       manifest="manifest_torch.json")
    if pl422[3] != want422:
        fail(f"runs {S422}: launches {pl422[3]}, want {want422}")
    small = chroma_manifest()
    k4_by_fmt = {0: 0, 2: 0, 3: 0}
    for name, (manifest, m) in small.items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            p, s_, ln, _ = decode(name, f.read(), manifest)
        _, splans = parse(name)
        dev_intra = sum(frame_compatible(q) and frame_has_intra(q)
                        for q in splans)
        rejected = sum(not frame_compatible(q) for q in splans)
        scfg = stream_cfg(splans, splans[0].sps)
        groups = 1 + bool(any(e[0] == 1 for e in scfg.intra)
                          and scfg.intra_scan[1])
        k4_by_fmt[m["chroma_format"]] += ln[3]
        log(f"decode {name}: {len(p)} frames, chroma format "
            f"{m['chroma_format']}, {m['bit_depth']} bits, MD5-equal to "
            f"{manifest}; {routes(name, s_, rejected)}; launches K1 "
            f"{ln[0]}, K2 {ln[1]}, K3 {ln[2]}, K4 {ln[3]} ({dev_intra} "
            f"device frames with intra TUs, {groups} plane groups)")
        if rejected and "ccp" not in name:
            fail(f"{name}: frame_compatible refuses {rejected} frames")
        if ln[3] != groups * dev_intra:
            fail(f"{name}: K4 launched {ln[3]} times, want {groups} for "
                 f"each of {dev_intra} device frames with intra TUs")
    log(f"{len(small)} small vectors (9 at 4:2:2, 15 at 4:4:4, 7 "
        f"monochrome) MD5-equal; K4 launches by format {k4_by_fmt}")
    if len(small) != 31:
        fail(f"{len(small)} small non-4:2:0 vectors, want 31")
    k3c, k4c, mc422 = check_422_kernels(
        dev, rng, plans422, ("rext_444_104x72", "rext_mono_104x72"))
    del plans422
    torch.cuda.empty_cache()

    # ---- 13: the hybrid device path. The 4K Main 4:2:2 10 stream with CU
    # chroma QP offsets (every frame refused by the frame program) through
    # the user's entry point; its stages on the IDR and a P frame; K3 on
    # its planes; the numpy host path on its first two frames; then the
    # 13 small vectors with refused frames
    dcq, plans13 = parse(S422_CQO)
    p13, st13, ln13, wall13 = decode(S422_CQO, dcq, "manifest_torch.json")
    n13 = len(p13)
    log(f"decode {S422_CQO}: {n13} frames {p13[0].width}x{p13[0].height} "
        f"chroma {p13[0].planes[1].shape} {p13[0].planes[0].dtype} "
        f"MD5-equal to manifest_torch.json; n_hybrid_frames "
        f"{st13['n_hybrid_frames']}, n_host_frames {st13['n_host_frames']}; "
        f"parse {st13['parse_s']:.3f} s, device decode incl. download "
        f"{st13['decode_s']:.3f} s; wall {wall13:.3f} s = "
        f"{n13 / wall13:.2f} fps; launches K1 {ln13[0]}, K2 {ln13[1]}, K3 "
        f"{ln13[2]}, K4 {ln13[3]}, K5 {ln13[4]}")
    # K1 once a frame (4:2:2: the tile table is luma's), K3 once a plane
    want13 = [n13, 0, 3 * n13, 0, 0]
    if st13["n_hybrid_frames"] != n13 or st13["n_host_frames"] \
            or ln13 != want13:
        fail(f"{S422_CQO}: {st13['n_hybrid_frames']} hybrid and "
             f"{st13['n_host_frames']} host frames, launches {ln13}; want "
             f"{n13}, 0 and {want13}")
    dec13, stimes, k3_args = hybrid_stages(dev, plans13)
    for i, rows in stimes.items():
        what = "IDR" if i == 0 else "P frame"
        log(f"hybrid stages, {S422_CQO} frame {i} (4K {what}; CUDA events "
            f"ms / host wall ms, synchronised between stages): "
            + "; ".join(f"{nm} {ms:.3f} / {w:.3f}" for nm, ms, w in rows))
    from libde265_tpu_torch.intra_wavefront import wavefront_stats
    ws = wavefront_stats(plans13[0])
    log(f"hybrid intra, {S422_CQO} IDR: {int(ws['hist'][1:].sum())} intra "
        f"TUs of {ws['tus']} in {ws['n_levels']} wavefront levels "
        f"({ws['per_level_mean']:.1f} a level)")
    k3y = check_k3_hybrid(k3_args)
    del k3_args
    host_s = numpy_frames(dec13, plans13, S422_CQO, "manifest_torch.json")
    log(f"numpy host path (reconstruct_frame), {S422_CQO}: frame 0 (IDR) "
        f"{host_s[0]:.3f} s, frame 1 (P) {host_s[1]:.3f} s, both MD5-equal")
    del dec13, plans13
    torch.cuda.empty_cache()
    tot = [0, 0]
    for name, (manifest, nhyb, nhost) in REFUSED.items():
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            p, s_, ln, _ = decode(name, f.read(), manifest)
        log(f"decode {name}: {len(p)} frames MD5-equal to {manifest}; "
            f"{routes(name, s_, nhyb + nhost)}; launches K1 {ln[0]}, K2 "
            f"{ln[1]}, K3 {ln[2]}, K4 {ln[3]}")
        if (s_["n_hybrid_frames"], s_["n_host_frames"]) != (nhyb, nhost):
            fail(f"{name}: want {nhyb} hybrid and {nhost} host frames")
        tot[0] += nhyb
        tot[1] += nhost
    log(f"{len(REFUSED)} vectors with refused frames: {tot[0]} hybrid and "
        f"{tot[1]} numpy host frames, every frame MD5-equal")
    if tot != [20, 21]:
        fail(f"refused frames routed {tot}, want 20 hybrid and 21 host")

    # ---- 14: the push API at full width. ld4k_light pushed in 64 KiB
    # pieces, each with its own pts, counters zeroed just before; then
    # p_hash_sei and rxt_cqo (hybrid frames) with their SEI hash checks
    chunk = 64 * 1024
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    ppics, pdec, pwall = push_decode(data, chunk, "cuda")
    pln = [f.launches for f in counters]
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        man = json.load(f)[STREAM]
    if len(ppics) != man["frames"]:
        fail(f"push API {STREAM}: {len(ppics)} pictures, want "
             f"{man['frames']}")
    want_pts = expected_pts(data, chunk)
    for i, pic in enumerate(ppics):
        got = [hashlib.md5(np.ascontiguousarray(q).tobytes()).hexdigest()
               for q in pic.planes]
        if got != [man["md5"][i][c] for c in ("y", "u", "v")]:
            fail(f"push API {STREAM} frame {i} (poc {pic.poc}): MD5 differs")
        if pic.pts != want_pts[pic.plan.frame_id]:
            fail(f"push API {STREAM} frame {i}: pts {pic.pts}, want "
                 f"{want_pts[pic.plan.frame_id]}")
    pst = pdec.stats
    log(f"push API {STREAM}: {len(ppics)} frames MD5-equal to "
        f"manifest_big.json, each with the pts of the push that completed "
        f"its first slice ({len(data)} bytes in {-(-len(data) // chunk)} "
        f"pushes of {chunk}); {pst['n_segments']} segment(s), "
        f"n_python_segments {pst['n_python_segments']}, n_host_frames {pst['n_host_frames']}, n_hybrid_frames "
        f"{pst['n_hybrid_frames']}; launches K1 {pln[0]}, K2 {pln[1]}, K3 "
        f"{pln[2]}, K4 {pln[3]}; wall {pwall:.3f} s = "
        f"{len(ppics) / pwall:.2f} fps (phase 4, decode_stream_native: "
        f"{wall4:.3f} s = {nfr / wall4:.2f} fps)")
    if pst["n_host_frames"] or pln[:4] != [66, 64, 99, 2]:
        fail(f"push API {STREAM}: {pst['n_host_frames']} host frames, "
             f"launches {pln[:4]}; want 0 and K1 66, K2 64, K3 99, K4 2")
    for name, manifest in (("p_hash_sei", "manifest_inter.json"),
                           ("rxt_cqo", "manifest_rext_tools.json")):
        with open(os.path.join(DATA, name + ".bin"), "rb") as f:
            sdata = f.read()
        spics, sdec, _ = push_decode(sdata, 997, "cuda")
        nh = sei_hash_count(sdata)
        ws = warnings_of(sdec)
        with open(os.path.join(DATA, manifest)) as f:
            sman = json.load(f)[name]
        for i, pic in enumerate(spics):
            if [pic.plane_md5(c) for c in range(3)] != \
                    [sman["md5"][i][c] for c in ("y", "u", "v")]:
                fail(f"push API {name} frame {i}: MD5 differs")
        log(f"push API {name}: {len(spics)} frames MD5-equal to {manifest}; "
            f"SEI hash checks passed {sdec.hash_checks_passed} of {nh}; "
            f"warnings {ws}; n_hybrid_frames {sdec.stats['n_hybrid_frames']}")
        if len(spics) != sman["frames"] or not nh \
                or sdec.hash_checks_passed != nh or ws:
            fail(f"push API {name}: {len(spics)} frames, hash checks "
                 f"{sdec.hash_checks_passed} of {nh}, warnings {ws}")
    if sdec.stats["n_hybrid_frames"] != 4:
        fail(f"push API rxt_cqo: {sdec.stats['n_hybrid_frames']} hybrid "
             f"frames, want 4")

    # ---- 15: decode_gop_parallel on gop1080p, four spawned workers on
    # this card; then a stream the GOP decoder refuses (rxt_cqo twice
    # over: hybrid frames), which the workers take
    from libde265_tpu_torch.parallel.gop_parallel import decode_gop_parallel
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    wst = {}
    t0, e0 = time.perf_counter(), time.time()
    wframes = decode_gop_parallel(gdata, workers=4, backend="workers",
                                  devices=["cuda:0"], stats=wst)
    wwall, e1 = time.perf_counter() - t0, time.time()
    md5_check(GOP_STREAM, wframes, "manifest_big.json")
    wln = wst["launches"]
    per = wst["per_gop"]
    log(f"decode_gop_parallel {GOP_STREAM}: {len(wframes)} frames in "
        f"{wst['n_gops']} segments, 4 spawned workers on cuda:0, MD5-equal "
        f"to manifest_big.json; route {wst['route']}; n_host_frames "
        f"{wst['n_host_frames']}, n_hybrid_frames {wst['n_hybrid_frames']}"
        f"; launches summed over the workers K1 {wln[0]}, K2 {wln[1]}, K3 "
        f"{wln[2]}, K4 {wln[3]}; wall {wwall:.3f} s = "
        f"{len(wframes) / wwall:.2f} fps (a segment's worker wall "
        f"{min(x['wall_s'] for x in per):.3f}-"
        f"{max(x['wall_s'] for x in per):.3f} s, the first starting "
        f"{min(x['start'] for x in per) - e0:.3f} s into the call, the "
        f"last ending {e1 - max(x['end'] for x in per):.3f} s before its "
        f"end); phase 11: GOP decoder "
        f"{gwall:.3f} s, one decoder {swall:.3f} s; parent launches "
        f"{[f.launches for f in counters]}")
    if wst["route"] != "workers" or wst["n_gops"] != 16 or wln[3] != 32 \
            or wst["n_host_frames"] or wln[:3] != gln[:3]:
        fail(f"decode_gop_parallel {GOP_STREAM}: route {wst['route']}, "
             f"{wst['n_gops']} segments, launches {wln}; want workers, 16, "
             f"K4 32 and K1-K3 {gln[:3]}")
    with open(os.path.join(DATA, "rxt_cqo.bin"), "rb") as f:
        cq2 = f.read() * 2
    cst = {}
    cframes = decode_gop_parallel(cq2, devices=["cuda:0"], stats=cst)
    md5_check("rxt_cqo", cframes, "manifest_rext_tools.json", repeat=2)
    log(f"decode_gop_parallel rxt_cqo x2: route {cst['route']}, "
        f"{len(cframes)} frames MD5-equal, n_hybrid_frames "
        f"{cst['n_hybrid_frames']}, n_host_frames {cst['n_host_frames']}")
    if cst["route"] != "workers" or cst["n_hybrid_frames"] != 8:
        fail(f"decode_gop_parallel rxt_cqo x2: route {cst['route']}, "
             f"{cst['n_hybrid_frames']} hybrid frames; want workers and 8")

    # ---- 16: backend.reconstruct_frame_device on the card
    for name, k3n in check_backend_filters(dev, counters):
        log(f"backend.reconstruct_frame_device {name} IDR: equal to the "
            f"numpy reference's filtered frame; K3 launched {k3n} times")

    # ---- 17: the port's encoder; its streams decoded on the card
    from libde265_tpu_torch.api import decode_stream_native as dsn
    frames17 = encoder_frames(ENC_FRAMES, ENC_W, ENC_H)
    t0 = time.perf_counter()
    edata, erec, esecs = port_encode(ENC_W, ENC_H, ENC_SETTINGS, frames17)
    ewall = time.perf_counter() - t0
    log(f"port encoder {ENC_W}x{ENC_H} (ld4k_light's settings, hash SEI): "
        f"{len(edata)} bytes for {ENC_FRAMES} frames in {ewall:.3f} s on "
        f"the host, {ewall / ENC_FRAMES:.3f} s a frame; frames "
        f"{', '.join(f'{x:.3f}' for x in esecs)} s")
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    est = {}
    t0 = time.perf_counter()
    epics = dsn(edata, device="cuda", stats=est)
    e_wall = time.perf_counter() - t0
    eln = [f.launches for f in counters]
    recon_check("port-encoded 1080p", epics, erec)
    n17 = len(erec)
    want17 = [2 * n17, 2 * (n17 - 1), 3 * n17, 2, 0]
    log(f"decode_stream_native port-encoded 1080p: {len(epics)} frames "
        f"equal to the encoder's reconstruction; n_host_frames "
        f"{est['n_host_frames']}, n_hybrid_frames {est['n_hybrid_frames']}; "
        f"launches K1 {eln[0]}, K2 {eln[1]}, K3 {eln[2]}, K4 {eln[3]}, K5 "
        f"{eln[4]}; wall {e_wall:.3f} s = {n17 / e_wall:.2f} fps (parse "
        f"{est['parse_s']:.3f} s, pack {est['pack_s']:.3f} s, device decode "
        f"incl. pack and download {est['decode_s']:.3f} s)")
    if est["n_host_frames"] or est["n_hybrid_frames"] or eln != want17:
        fail(f"port-encoded 1080p: host {est['n_host_frames']}, hybrid "
             f"{est['n_hybrid_frames']}, launches {eln}; want 0, 0, {want17}")
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    qpics, qdec, qwall = push_decode(edata, 64 * 1024, "cuda")
    qln = [f.launches for f in counters]
    recon_check("port-encoded 1080p, push API", qpics, erec)
    nh17, ws17 = sei_hash_count(edata), warnings_of(qdec)
    log(f"push API port-encoded 1080p: {len(qpics)} frames equal to the "
        f"encoder's reconstruction; SEI hash checks passed "
        f"{qdec.hash_checks_passed} of {nh17}; warnings {ws17}; launches "
        f"K1 {qln[0]}, K2 {qln[1]}, K3 {qln[2]}, K4 {qln[3]}; wall "
        f"{qwall:.3f} s = {n17 / qwall:.2f} fps")
    if nh17 != n17 or qdec.hash_checks_passed != n17 or ws17 \
            or qln != want17 or qdec.stats["n_host_frames"]:
        fail(f"push API port-encoded 1080p: hash checks "
             f"{qdec.hash_checks_passed} of {nh17} (want {n17}), warnings "
             f"{ws17}, launches {qln} (want {want17})")
    qual = check_quality(epics, frames17)
    log("quality.psnr / ssim on the card (equal to the CPU values): "
        + "; ".join(f"frame {i} PSNR Y {r[0]:.4f} U {r[2]:.4f} V "
                    f"{r[3]:.4f} dB, SSIM Y {r[1]:.6f}"
                    for i, r in enumerate(qual)))
    del epics, qpics, qdec
    tw, th, tset = ENC_TILED
    ncols = tset["tiles"][0]
    tdata, trec, _ = port_encode(tw, th, tset, encoder_frames(4, tw, th))
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    tst17 = {}
    tpics = dsn(tdata, device="cuda", stats=tst17,
                tile_devices=["cuda:0"] * ncols)
    tln17 = [f.launches for f in counters]
    recon_check("port-encoded tiles", tpics, trec)
    nf, ns = len(tpics), tst17["n_strip_frames"]
    twant = [2 * nf, 2 * ncols * ns, 3 * (nf - ns + ncols * ns), None,
             2 * ns]
    log(f"tile-column decoder, port-encoded {tw}x{th} ({ncols} tile "
        f"columns on cuda:0): {nf} frames equal to the encoder's "
        f"reconstruction; strip frames {ns}; launches K1 {tln17[0]}, K2 "
        f"{tln17[1]}, K3 {tln17[2]}, K4 {tln17[3]}, K5 {tln17[4]}")
    if ns != nf - 1 or tst17["n_host_frames"] or tln17[3] < 1 or \
            [tln17[i] for i in (0, 1, 2, 4)] != \
            [twant[i] for i in (0, 1, 2, 4)]:
        fail(f"port-encoded tiles: {ns} strip frames of {nf - 1}, launches "
             f"{tln17}; want {twant} (K4 >= 1)")
    with open(os.path.join(DATA, SCALING_HYBRID + ".bin"), "rb") as f:
        sdata17 = f.read()
    sp, ss, sl, _ = decode(SCALING_HYBRID, sdata17, "manifest_torch.json")
    log(f"decode {SCALING_HYBRID} (scaling lists on the hybrid path): "
        f"{len(sp)} frames MD5-equal to manifest_torch.json; "
        f"n_hybrid_frames {ss['n_hybrid_frames']}, n_host_frames "
        f"{ss['n_host_frames']}; launches K1 {sl[0]}, K3 {sl[2]}")
    if (ss["n_hybrid_frames"], ss["n_host_frames"]) != (len(sp), 0):
        fail(f"{SCALING_HYBRID}: {ss['n_hybrid_frames']} hybrid and "
             f"{ss['n_host_frames']} host frames; want every frame hybrid")
    for H, W, tiles, n_tu, ms, csum in check_tile_mesh():
        log(f"tile_mesh step {W}x{H} on {tiles} x cuda:0, {n_tu} TUs: "
            f"equal to the CPU run (checksum {csum}); {ms:.4f} ms a step "
            f"(CUDA events)")

    # ---- 18: the per-picture push decoder (parse="python"), counters
    # zeroed just before its main path
    del tpics
    torch.cuda.empty_cache()
    ln18 = check_push_python(counters, data, pwall, wall4)

    # ---- 19: the command-line tools, counters zeroed just before
    # dec265's run on the main path
    torch.cuda.empty_cache()
    ln19 = check_tools(counters, wall4)

    # ---- 20: the measurement tools, counters zeroed just before
    # tools.bench's run on the main path
    torch.cuda.empty_cache()
    ln20 = check_bench_tools(counters)

    ms_i, ms_p = frame_times(dev, plans)
    log(f"frame program (CUDA events): 4K IDR {ms_i:.3f} ms, 4K P frame "
        f"{ms_p:.3f} ms")
    ms_t = tile_frame_ms(dev, tile_plans)
    log(f"{TILE_STREAM}: decode wall {twall:.3f} s (parse "
        f"{tst['parse_s']:.3f} s, pack {tst['pack_s']:.3f} s, device "
        f"decode incl. pack and download {tst['decode_s']:.3f} s); strip "
        f"program (CUDA events) {ms_t:.3f} ms per 1080p P frame, 4 strips "
        f"on one card")

    def worst(rows):
        return max(r[1] for r in rows)

    def row(name, src, replaces, launched, rows, r):
        return {"name": name, "route": "cuda",
                "source": f"libde265_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": worst(rows), "ms": r[2], "plain_ms": r[3],
                "bound_ms": r[4][0], "bound_by": r[4][1],
                "library_ms": r[5] if len(r) > 5 else None}
    k4_4k = [r for r in k4 if r[0].startswith(STREAM)]
    kernels = [
        row("K1 tile-table update (4K luma slot)", "mc_tables.cu",
            "libde265_tpu/ops/pallas/mc_tables.py:263", launches[0], k1,
            k1[0]),
        row("K2 MC (4K P frame luma)", "mc_filter.cu",
            "libde265_tpu/ops/pallas/mc_filter.py:67", launches[1], k2,
            k2[0]),
        row("K3 SAO from the CTB parameters (4K P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            launches[2], k3, k3[0]),
        *(row(f"K4 intra scan (4K IDR {grp}, whole frame)", "intra_scan.cu",
              "libde265_tpu/ops/pallas/intra_scan.py:502", launches[3], k4,
              r) for grp, r in zip(("luma", "Cb|Cr"), k4_4k)),
        row(f"K5 tile-table build ({k5[0][0]}, luma + Cb|Cr, 2 launches)",
            "mc_tables.cu", "libde265_tpu/ops/pallas/mc_tables.py:138",
            tln[4], k5, k5[0]),
        *(row(f"K6 deblocking ({r[0]}, Y, Cb and Cr, 2 launches)",
              "deblock.cu", "none (XLA ops: libde265_tpu/ops/deblock_jax.py)",
              launches6, k6, r) for r in k6),
        row(f"K2 MC, strip form ({TILE_STREAM} P frame strip 1 luma)",
            "mc_filter.cu", "libde265_tpu/ops/pallas/mc_filter.py:67",
            tln[1], k2s, k2s[0]),
        row(f"K1 tile-table update, int16 table ({MAIN10} 4K luma slot)",
            "mc_tables.cu", "libde265_tpu/ops/pallas/mc_tables.py:263",
            ln10[0], k1h, k1h[0]),
        row(f"K2 MC, 10-bit ({MAIN10} P frame luma, int16 tables)",
            "mc_filter.cu", "libde265_tpu/ops/pallas/mc_filter.py:67",
            ln10[1], k2h, k2h[0]),
        row(f"K3 SAO, 10-bit ({MAIN10} P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            ln10[2], k3h, k3h[0]),
        *(row(f"K4 intra scan, 10-bit ({MAIN10} IDR {grp}, whole frame)",
              "intra_scan.cu", "libde265_tpu/ops/pallas/intra_scan.py:502",
              ln10[3], k4h, r) for grp, r in zip(("luma", "Cb|Cr"), k4h)),
        row(f"K3 SAO, 4:2:2 chroma ({S422} P frame Cb plane, 32x64 "
            f"CTBs)", "sao_filter.cu",
            "libde265_tpu/ops/pallas/sao_filter.py:87", ln422[2], k3c,
            k3c[1]),
        row(f"K4 intra scan, 4:2:2 chroma ({S422} IDR Cb|Cr, whole frame, "
            f"BW 32, BH 64)", "intra_scan.cu",
            "libde265_tpu/ops/pallas/intra_scan.py:502", ln422[3], k4c,
            k4c[0]),
        row("K4 intra scan, 4:4:4 chroma (rext_444_104x72 IDR Cb|Cr)",
            "intra_scan.cu", "libde265_tpu/ops/pallas/intra_scan.py:502",
            k4_by_fmt[3], k4c, k4c[2]),
        row("K4 intra scan, monochrome (rext_mono_104x72 IDR luma)",
            "intra_scan.cu", "libde265_tpu/ops/pallas/intra_scan.py:502",
            k4_by_fmt[0], k4c, k4c[3]),
        row(f"K3 SAO, hybrid path ({S422_CQO} P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            ln13[2], k3y, k3y[0]),
        row("K1 tile-table update, per-picture push path (4K luma slot)",
            "mc_tables.cu", "libde265_tpu/ops/pallas/mc_tables.py:263",
            ln18[0], k1, k1[0]),
        row("K2 MC, per-picture push path (4K P frame luma)",
            "mc_filter.cu", "libde265_tpu/ops/pallas/mc_filter.py:67",
            ln18[1], k2, k2[0]),
        row("K3 SAO, per-picture push path (4K P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            ln18[2], k3, k3[0]),
        row("K4 intra scan, per-picture push path (4K IDR luma, whole "
            "frame)", "intra_scan.cu",
            "libde265_tpu/ops/pallas/intra_scan.py:502", ln18[3], k4,
            k4_4k[0]),
        row("K1 tile-table update, dec265 CLI (4K luma slot)",
            "mc_tables.cu", "libde265_tpu/ops/pallas/mc_tables.py:263",
            ln19[0], k1, k1[0]),
        row("K2 MC, dec265 CLI (4K P frame luma)",
            "mc_filter.cu", "libde265_tpu/ops/pallas/mc_filter.py:67",
            ln19[1], k2, k2[0]),
        row("K3 SAO, dec265 CLI (4K P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            ln19[2], k3, k3[0]),
        row("K4 intra scan, dec265 CLI (4K IDR luma, whole frame)",
            "intra_scan.cu", "libde265_tpu/ops/pallas/intra_scan.py:502",
            ln19[3], k4, k4_4k[0]),
        row("K1 tile-table update, tools.bench (4K luma slot)",
            "mc_tables.cu", "libde265_tpu/ops/pallas/mc_tables.py:263",
            ln20[0], k1, k1[0]),
        row("K2 MC, tools.bench (4K P frame luma)",
            "mc_filter.cu", "libde265_tpu/ops/pallas/mc_filter.py:67",
            ln20[1], k2, k2[0]),
        row("K3 SAO, tools.bench (4K P frame luma plane)",
            "sao_filter.cu", "libde265_tpu/ops/pallas/sao_filter.py:87",
            ln20[2], k3, k3[0]),
        row("K4 intra scan, tools.bench (4K IDR luma, whole frame)",
            "intra_scan.cu", "libde265_tpu/ops/pallas/intra_scan.py:502",
            ln20[3], k4, k4_4k[0]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
