"""The mean host time to enqueue one decode step: the program's
``serve.decode.launch`` spans, inside its decode step and so inside any
wrapper around it; None where the program has no recorder or kept no
span."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    walls = [s.seconds for s in obs.spans(run.window)
             if s.name == "serve.decode.launch"] if obs else []
    if not walls:
        return None
    return sum(walls) / len(walls) * 1e3
