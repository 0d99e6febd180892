"""kernels_roofline: the hand-written kernels' share of their roofline,
in %: the sum over their launches in the trace of the least time the
card could take for each (the larger of its bytes over the HBM rate and
its operations over the operation rate, benchmark/roofline/<kernel>.py
from the picture's shapes, benchmark/peaks.json), over the sum of their
durations in the trace. None where the trace holds none of them."""


def read(run):
    t = run.trace
    if t is None:
        return None
    hbm = run.peaks["hbm_bytes_per_s"]
    ops = run.peaks["int32_ops_per_s"]
    bound = spent = 0.0
    for mod in run.rooflines:
        n, dur = 0, 0.0
        for name, (count, s) in t.kernels.items():
            if mod.KERNEL in name:
                n += count
                dur += s
        if not n:
            continue
        group = mod.launches(run.config["geometry"])
        per_group = sum(max(b / hbm, o / ops) for b, o in group)
        bound += n / len(group) * per_group
        spent += dur
    return 100.0 * bound / spent if spent > 0 else None
