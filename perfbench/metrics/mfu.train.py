"""The window's model FLOPs (``perfbench.flops.train_flops``: top-k
routed experts, causal attention) over the summed walls of its steps,
as a share of the card's dense bf16 peak."""

from perfbench import flops


def read(run):
    if not run.steps:
        return None
    t = run.traffic
    f = flops.train_flops(run.spec, t["batch"], t["seq_len"])
    wall = sum(s["wall_s"] for s in run.steps)
    return 100.0 * f * len(run.steps) / wall / flops.BF16_PEAK_FLOPS
