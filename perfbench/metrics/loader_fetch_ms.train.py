"""The mean time the loader's producer took to make one batch (the
store read: runs, ``select_packed`` over the OSDs, assembly): the
program's ``loader.fetch`` spans that lie inside the window; None where
the program has no recorder or kept no fetch."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    walls = [s.seconds for s in obs.spans(run.window)
             if s.name == "loader.fetch"] if obs else []
    if not walls:
        return None
    return sum(walls) / len(walls) * 1e3
