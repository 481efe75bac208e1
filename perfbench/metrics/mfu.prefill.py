"""Prefill model FLOPs (``perfbench.flops.prefill_flops`` of every
request's own prompt length, pads left out) over the summed
synchronised prefill walls, as a share of the card's dense bf16 peak."""

from perfbench import flops


def read(run):
    walls = run.span_walls("engine.prefill")
    if not walls or len(walls) != len(run.batches):
        return None
    f = flops.prefill_flops(run.spec, [r["prompt_len"] for r in run.requests])
    return 100.0 * f / sum(walls) / flops.BF16_PEAK_FLOPS
