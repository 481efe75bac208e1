"""The mean device interval of a traced step's AdamW update: from the
first to the last of its work on the card (idle time inside included),
between the CUDA events of the program's ``train.optimizer`` spans;
None where the program has no recorder or no interval was kept."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    ms = [s.device_ms for s in obs.spans(run.window)
          if s.name == "train.optimizer" and s.device_ms is not None] \
        if obs else []
    if not ms:
        return None
    return sum(ms) / len(ms)
