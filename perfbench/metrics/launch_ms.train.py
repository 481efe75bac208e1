"""The mean host time a traced step spent enqueueing its work: the
program's ``train.launch`` spans (unpack, forward, backward and AdamW
launched), from its own recorder, which records while the profiler
does; None where the program has no recorder or kept no span."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    walls = [s.seconds for s in obs.spans(run.window)
             if s.name == "train.launch"] if obs else []
    if not walls:
        return None
    return sum(walls) / len(walls) * 1e3
