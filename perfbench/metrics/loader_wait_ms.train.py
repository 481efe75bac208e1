"""The time a traced step waited on the loader's prefetch queue: the
program's ``loader.wait`` spans summed over its ``train.step`` spans
(host clock, inside the program: the twin of ``ingest_wait_ms.train``);
None where the program has no recorder or kept no step."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    spans = obs.spans(run.window) if obs else []
    steps = sum(s.name == "train.step" for s in spans)
    if not steps:
        return None
    return sum(s.seconds for s in spans if s.name == "loader.wait") \
        / steps * 1e3
