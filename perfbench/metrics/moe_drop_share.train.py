"""The share of routed (token, expert) entries that the capacity-bounded
dispatch dropped over the traced steps: 100 * the program's
``moe.dropped`` counter over its ``moe.routed``, once per routing
decision (not again in the backward's recomputation); None where the
program has no recorder or counted nothing."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    sums = {"moe.routed": 0.0, "moe.dropped": 0.0}
    for c in obs.counts(run.window) if obs else []:
        if c.name in sums:
            sums[c.name] += c.value
    if not sums["moe.routed"]:
        return None
    return 100.0 * sums["moe.dropped"] / sums["moe.routed"]
