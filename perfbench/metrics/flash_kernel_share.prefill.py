"""The share of the prefill's attention calls that took the hand-written
inference kernel: 100 * the program's ``attn.flash_kernel`` counter over
its ``attn.flash`` counter inside the window (one of each a layer's
call); None where the program has no recorder or counted no call, as a
program without those counters."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    sums = {"attn.flash": 0.0, "attn.flash_kernel": 0.0}
    for c in obs.counts(run.window) if obs else []:
        if c.name in sums:
            sums[c.name] += c.value
    if not sums["attn.flash"]:
        return None
    return 100.0 * sums["attn.flash_kernel"] / sums["attn.flash"]
