"""The caching allocator's retries (a failed allocation that frees the
cache and tries again) a traced step: the program's ``alloc.retries``
counter, the rise of ``num_alloc_retries`` across each ``train.step``,
over the traced steps; None where the program has no recorder or
counted nothing."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    if obs is None:
        return None
    steps = sum(s.name == "train.step" for s in obs.spans(run.window))
    retries = [c.value for c in obs.counts(run.window)
               if c.name == "alloc.retries"]
    if not steps or not retries:
        return None
    return sum(retries) / steps
