"""The 90th percentile, over every request completed in the window, of
the time from its send to the return of the engine's call with its
completion (nearest rank), host clock."""

import math


def read(run):
    lat = sorted(r["done"] - r["sent"] for r in run.requests)
    if not lat:
        return None
    return lat[math.ceil(0.9 * len(lat)) - 1] * 1e3
