"""The mean time a window step waited on the loader: the benchmark's
own timer around each ``next`` the Trainer makes on it (store read,
``select_packed``, the prefetch queue), host clock."""


def read(run):
    walls = run.span_walls("loader.next")
    if not walls or not run.steps:
        return None
    return sum(walls) / len(run.steps) * 1e3
