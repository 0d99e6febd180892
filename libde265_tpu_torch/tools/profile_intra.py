"""profile_intra: where a stream's IDR spends its intra time
(counterpart of the JAX package's tools/profile_intra.py).

    python -m libde265_tpu_torch.tools.profile_intra [STREAM]
        [--reps 3] [--device cuda|cpu]

STREAM defaults to ld4k_light (tests/data). On zeroed planes, the IDR's
intra stage:
- through K4: the stage as the frame program runs it
  (intra_fused.intra_stage_scan: both plane groups, the kernels' inputs
  built in each call), then the launch of luma alone and of the [Cb|Cr]
  group alone on inputs built once, each with its critical path in TU
  steps (profile_frames.wavefront_steps over band_waits) beside its TU
  count;
- through the wavefront-level path (ops/intra.intra_reconstruct_device,
  the hybrid path's intra): its time, its level count and the cost of
  one level (time / levels).
Times are the best of `reps` calls (CUDA events on the card). Prints a
line per case and one JSON line.
"""
import argparse
import json
import os
import sys

from .bench import DATA, _seconds, device_name


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_intra")
    ap.add_argument("stream", nargs="?", default="ld4k_light")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from dataclasses import replace
    from ..api import _parse
    from ..convert import plan_from_numpy
    from ..device import resolve
    from ..device_decode import new_planes
    from ..frame_program import frame_grids
    from ..intra_fused import intra_stage_scan, scan_groups
    from ..intra_wavefront import assign_levels
    from ..ops.intra import intra_reconstruct_device
    from ..ops.kernels.intra_scan import band_waits, intra_scan
    from ..packing import frame_has_intra, pack_frame, stream_cfg
    from ..profile_frames import wavefront_steps
    dev = resolve(args.device)
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        plans = _parse(f.read())
    plan = next(p for p in plans if p.nal_type != -1 and frame_has_intra(p))
    cfg = replace(stream_cfg(plans, plans[0].sps), skip_mc=True)
    t = frame_grids(plan_from_numpy(pack_frame(plan, cfg,
                                               {plan.frame_id: 0}), dev), cfg)
    print(f"# {device_name(dev)}: {args.stream} IDR POC {plan.poc}, intra "
          f"classes {cfg.intra}", flush=True)
    zero = new_planes(plan, dev)

    def best(fn):
        fn()                                          # warm-up
        return min(_seconds(dev, fn, 1) for _ in range(args.reps)) * 1e3

    out = {"stream": args.stream, "device": device_name(dev)}
    planes = [p.clone() for p in zero]
    out["k4_ms"] = best(lambda: intra_stage_scan(*planes, t, cfg))
    print(f"K4, both plane groups (the stage as the frame program runs "
          f"it, its inputs built in each call): {out['k4_ms']:.3f} ms")
    for idx, kw in scan_groups(t, cfg):
        name = "luma" if idx == (0,) else "chroma"
        grp = [planes[i] for i in idx]
        ms = best(lambda: intra_scan(grp, **kw))
        steps, ntu = wavefront_steps(kw["recs"], kw["K"], band_waits(
            kw["recs"], kw["K"], kw["BW"]))
        out[f"k4_{name}_ms"], out[f"k4_{name}_steps"] = ms, steps
        out[f"k4_{name}_tus"] = ntu
        print(f"K4, {name} alone: {ms:.3f} ms; critical path {steps} TU "
              f"steps of {ntu} TUs")
    levels = assign_levels(plan)[1]
    planes = [p.clone() for p in zero]
    ms = best(lambda: intra_reconstruct_device(plan, planes,
                                               cfg.bitdepth))
    out.update(levels_ms=ms, levels=levels, level_ms=ms / max(1, levels))
    print(f"wavefront levels (the hybrid path): {ms:.3f} ms, {levels} "
          f"levels, {ms / max(1, levels):.4f} ms a level")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
