"""The share of the traced window in which no operation ran on the
card: 1 - (the union of the device events' intervals) / (the window),
from ``torch.profiler``'s device trace."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
