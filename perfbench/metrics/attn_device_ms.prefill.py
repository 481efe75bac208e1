"""The device time of a prefill's attention: for each traced prefill,
the sum of the device intervals of its layers' ``model.attn`` spans
(each from its first to its last work on the card), averaged over the
prefills; None where the program has no recorder or no interval was
kept."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    spans = obs.spans(run.window) if obs else []
    per = {s.id: 0.0 for s in spans if s.name == "serve.prefill"}
    seen = set()
    for s in spans:
        if s.name == "model.attn" and s.parent in per \
                and s.device_ms is not None:
            per[s.parent] += s.device_ms
            seen.add(s.parent)
    if not seen:
        return None
    return sum(per[i] for i in seen) / len(seen)
