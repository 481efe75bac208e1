"""Time to first token: over the traced batches, the mean time from the
start of the engine's call (``serve.generate``) to its
``serve.first_token`` instant, once the first token is on the host, as a
streaming engine's user would see it; None where the program has no
recorder or kept no such pair."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    spans = obs.spans(run.window) if obs else []
    start = {s.id: s.start_s for s in spans if s.name == "serve.generate"}
    waits = [s.start_s - start[s.parent] for s in spans
             if s.name == "serve.first_token" and s.parent in start]
    if not waits:
        return None
    return sum(waits) / len(waits) * 1e3
