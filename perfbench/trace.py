"""The device trace of a traced run, and its reduction.

``Tracer`` runs ``torch.profiler`` over the card's activity only (no
host operator events: a train step has some 200,000 of them) between
``start`` and ``stop``, both after a synchronise.  Right after the
start it launches one marker kernel (``torch.cuda._sleep``) at a known
host time, which ties the profiler's device clock to the host's
``perf_counter``, so each idle gap of the card can be named by the
benchmark's own host span that was open then.

``reduce`` turns the raw device events into what the result line
carries: the seconds in which some operation ran (the union of the
events' intervals), the traced window, the ten device operations with
the most time, and idle time by the host span open during it.
"""

from __future__ import annotations

import bisect
import collections
import time

MARKER = "spin_kernel"       # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000
NAME_CHARS = 160


class Tracer:
    def __init__(self):
        self.prof = None
        self.host = (0.0, 0.0)
        self.marker_host_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.marker_host_ns = int(t * 1e9)
        torch.cuda._sleep(MARKER_CYCLES)
        self.host = (t, t)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.host = (self.host[0], time.perf_counter())
        self.prof.stop()

    def events(self) -> list[tuple[int, int, str]]:
        """(start ns, end ns, name) of every device event, in the
        profiler's device clock."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s = (e.start_ns() if hasattr(e, "start_ns")
                 else int(e.start_us() * 1000))
            out.append((s, s + e.duration_ns(), e.name()))
        return out

    def summary(self, spans: list) -> dict:
        ev = self.events()
        marks = [s for s, _, n in ev if MARKER in n]
        offset = (marks[0] - self.marker_host_ns) if marks else None
        return reduce([e for e in ev if MARKER not in e[2]], self.host,
                      offset, spans)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _namer(spans: list):
    """time (s) -> the innermost (latest-started) span open then, for
    queries in increasing time; "harness" where none is."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    active: list = []
    i = 0

    def name(t: float) -> str:
        nonlocal i, active
        j = bisect.bisect_right(starts, t)
        active.extend(spans[i:j])
        i = max(i, j)
        active = [sp for sp in active if sp[2] > t]
        return active[-1][0] if active else "harness"
    return name


def reduce(events: list[tuple[int, int, str]], host: tuple[float, float],
           offset_ns: int | None, spans: list) -> dict:
    """The trace's summary.  ``events``: (start, end, name) in the device
    clock; ``host``: the traced window in host seconds; ``offset_ns``:
    device clock minus host clock (None: no marker was found; the
    window is then the events' own extent and gaps are unnamed);
    ``spans``: (name, start s, end s) on the host clock."""
    if offset_ns is None:
        lo = min((s for s, _, _ in events), default=0)
        hi = max((e for _, e, _ in events), default=0)
    else:
        lo = int(host[0] * 1e9) + offset_ns
        hi = int(host[1] * 1e9) + offset_ns
    clipped = [(max(s, lo), min(e, hi)) for s, e, _ in events
               if e > lo and s < hi]
    busy = _union(clipped)
    by_op: dict[str, float] = collections.defaultdict(float)
    for s, e, n in events:
        by_op[n[:NAME_CHARS]] += (e - s) / 1e9
    idle: dict[str, float] = collections.defaultdict(float)
    name = _namer(spans) if offset_ns is not None else (lambda t: "unaligned")
    prev = lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            idle[name(((prev + s) / 2 - (offset_ns or 0)) / 1e9)] += \
                (s - prev) / 1e9
        prev = max(prev, e)

    def top(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (hi - lo) / 1e9, "device_ops": top(by_op),
            "idle_gaps": top(idle)}
