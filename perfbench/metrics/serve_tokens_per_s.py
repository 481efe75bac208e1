"""Serving throughput: the completion tokens of every request completed
in the window, over the window (whole batches), host clock."""


def read(run):
    if not run.requests:
        return None
    return sum(r["served"] for r in run.requests) / run.window_s
