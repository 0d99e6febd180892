"""profile_frame_stages: ms per P frame of the frame program with stages
left out (counterpart of the JAX package's tools/profile_frame_stages.py,
through frame_program.decode_frame_device's `stages`).

    python -m libde265_tpu_torch.tools.profile_frame_stages [STREAM]
        [--rounds 6] [--frames N] [--manifest manifest_big.json]
        [--device cuda|cpu]

STREAM defaults to ld4k_light (tests/data). Its IDR decodes into DPB
slot 0 and its P frames (the first N with --frames) are packed once
under the static slot map (P frames cycling through slots 1..7) and
uploaded. Each variant of VARIANTS then runs over the P frames from a
copy of that state: one untimed pass, then `rounds` passes timed (CUDA
events on the card). Per variant one JSON line: ms and fps per frame,
and the kernel launches per frame (K1-K5; zeros on the CPU, where the
kernels' plain versions run). Then the deltas between variants as a
stage attribution. The default call (every stage) decodes the same
frames from the same state once more: each frame is held to the
manifest's MD5s and the final DPB stacks and tile tables to the `full`
variant's (a difference exits 1).
"""
import argparse
import json
import os
import sys

from .bench import (DATA, _seconds, _stack, device_name, frame_md5s,
                    static_slot_map)

VARIANTS = [
    ("none", ()),                            # the loop + DPB insert
    ("tables", ("tables",)),                 # + K1's table update
    ("mc_luma", ("mc", "mc_luma_only")),     # + luma MC only
    ("mc", ("mc",)),                         # + MC of both plane groups
    ("mc_res", ("mc", "res")),               # + residual batches
    ("mc_res_dbk", ("mc", "res", "dbk")),    # + deblocking
    ("full", ("mc", "res", "dbk", "sao", "tables")),   # == the default
]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_frame_stages")
    ap.add_argument("stream", nargs="?", default="ld4k_light")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--frames", type=int, default=0,
                    help="the first N P frames (default: all)")
    ap.add_argument("--manifest", default="manifest_big.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from dataclasses import replace
    import torch
    from ..api import _parse
    from ..convert import plan_from_numpy, to_tensor
    from ..device import resolve
    from ..device_stream import DeviceStreamDecoder
    from ..frame_program import decode_frame_device, unpack_blob
    from ..packing import blob_meta, frame_has_intra, pack_blob, pack_frame
    from ..parallel.gop_parallel import _counters
    dev = resolve(args.device)
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        plans = _parse(f.read())
    with open(os.path.join(DATA, args.manifest)) as f:
        man = json.load(f)[args.stream]
    dec = DeviceStreamDecoder(plans, plans[0].sps, dev)
    idr = plans[0]
    if not frame_has_intra(idr):
        raise ValueError(f"{args.stream}: the first frame is not an IDR")
    pframes = [p for p in plans[1:] if not frame_has_intra(p)]
    pframes = pframes[:args.frames or len(pframes)]
    cfg_i, cfg = replace(dec.cfg, skip_mc=True), dec.cfg_scan
    fid_slot = static_slot_map({"i": [idr], "p": pframes})
    decode_frame_device(*dec.state(), plan_from_numpy(
        pack_frame(idr, cfg_i, fid_slot), dev), 0, cfg_i)
    stacked = _stack([pack_frame(p, cfg, fid_slot) for p in pframes])
    meta, totals = blob_meta(stacked)
    ts = unpack_blob({dt: to_tensor(a, dev) for dt, a in
                      pack_blob(stacked, meta, totals).items()}, meta)
    frames = [({k: v[j] for k, v in ts.items()}, fid_slot[p.frame_id])
              for j, p in enumerate(pframes)]
    state0 = [a.clone() for a in dec.state()]
    counters = _counters()
    nf = len(frames)
    print(f"# {device_name(dev)}: {args.stream}, {nf} P frames",
          file=sys.stderr, flush=True)

    def run(state, stages=None):
        kw = {} if stages is None else {"stages": stages}
        for t, slot in frames:
            decode_frame_device(*state, t, slot, cfg, **kw)

    results, finals = {}, {}
    for name, stages in VARIANTS:
        state = [a.clone() for a in state0]
        run(state, stages)                            # untimed pass
        finals[name] = [a.clone() for a in state]
        before = [f.launches for f in counters]
        ms = _seconds(dev, lambda: run(state, stages), args.rounds) \
            * 1e3 / nf
        launches = [(f.launches - b) / (args.rounds * nf)
                    for f, b in zip(counters, before)]
        results[name] = ms
        print(json.dumps({"variant": name, "ms_per_frame": ms,
                          "fps": 1e3 / ms, "launches_per_frame": launches}),
              flush=True)
        del state

    # the default call from the same state, frame by frame against the
    # manifest, then its final state against the full variant's
    state = [a.clone() for a in state0]
    order = {p.frame_id: i for i, p in enumerate(plans)}
    bad = []
    for (t, slot), plan in zip(frames, pframes):
        decode_frame_device(*state, t, slot, cfg)
        if frame_md5s(plan, [p[slot] for p in state[:3]], dec.dtype) != \
                [man["md5"][order[plan.frame_id]][c] for c in "yuv"]:
            bad.append(plan.poc)
    same = all(torch.equal(a, b) for a, b in zip(state, finals["full"]))
    r = results
    attr = {"loop_dpb_insert": r["none"],
            "mc_table_update": r["tables"] - r["none"],
            "mc_luma": r["mc_luma"] - r["none"],
            "mc_chroma": r["mc"] - r["mc_luma"],
            "residuals": r["mc_res"] - r["mc"],
            "deblock": r["mc_res_dbk"] - r["mc_res"],
            "sao": r["full"] - r["mc_res_dbk"] - (r["tables"] - r["none"])}
    print(json.dumps({"stream": args.stream, "frames": nf,
                      "device": device_name(dev), "attribution_ms": attr,
                      "full_equals_default": same,
                      "default_md5_mismatch_pocs": bad}), flush=True)
    return 0 if same and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
