"""Training throughput: every token of the whole steps run in the
window, over the window (which ends at a step boundary), host clock."""


def read(run):
    if not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
