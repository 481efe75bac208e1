"""Spans and counters of the program, on the clock its device trace uses.

One recorder for the process, as ``logging`` is one:

  with obs.span("serve.prefill", device=x.device, batch=7):
      ...                                 # a named stretch of host time
  obs.instant("serve.first_token", batch=7)   # a span of no length
  obs.count("moe.dropped", (~keep).sum())     # adds to a counter

A span record holds its name, its start and end as
``time.perf_counter_ns()``, its id, the id of the span that caused it
(the innermost span open on the same thread when it started), its
thread and its attributes.  ``perf_counter`` is the clock that
``perfbench/trace.py`` ties to the profiler's device clock, so a record
is a ``(name, start s, end s)`` triple of that trace as it stands.

``device=`` a CUDA device also records a ``torch.cuda.Event`` (timing
on) on the device's current stream at each end.  The device interval
(``Span.device_ms``) is resolved when the records are read, never in
the span's own path, and no synchronise is added: it is the device's
wall from the region's first work to its last, idle time inside it
included.  A counter's value may be a 0-d device tensor; it stays on the
device until the counters are read, so a counter adds no host sync.

Recording is on while a ``torch.profiler`` session records (torch's
own flag for fast checks, ``torch.autograd.profiler.
_is_profiler_enabled``), and inside ``with recording():``.  Off, a span
site reads two flags and returns a shared null context: no clock read
and no event.  A span is kept if recording was on when it started.
``quiet()`` turns recording off on its thread: the backward's
recomputation of a checkpointed block runs under it, so the forward's
spans and counters are taken once.  Records go into a bounded deque
(the oldest go first), appended from any thread; ``spans()`` and
``counts()`` read them.  Nothing here emits a profiler range or an NVTX
range: under a profiler that records device activity those come back
as device events and would count as device work.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 17

_forced = 0                  # open ``recording()`` blocks
_forced_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()   # .stack: open span ids; .quiet: depth
_NULL = contextlib.nullcontext()


def on() -> bool:
    """Whether a span or counter started now on this thread is kept."""
    if not (_forced or _profiler._is_profiler_enabled):
        return False
    return not getattr(_local, "quiet", 0)


@contextlib.contextmanager
def recording():
    """Recording on inside the block, on every thread."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


@contextlib.contextmanager
def quiet():
    """Recording off on this thread inside the block."""
    _local.quiet = getattr(_local, "quiet", 0) + 1
    try:
        yield
    finally:
        _local.quiet -= 1


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: int | None
    thread: int
    attrs: dict
    start_ns: int
    end_ns: int = 0              # 0 while the span is open
    device_ms: float | None = None
    events: tuple | None = None  # (start, end) CUDA events until resolved

    @property
    def start_s(self) -> float:
        return self.start_ns / 1e9

    @property
    def end_s(self) -> float:
        return self.end_ns / 1e9

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass(eq=False)
class Count:
    name: str
    at_ns: int
    parent: int | None
    thread: int
    raw: Any                     # a number, or a 0-d tensor until read

    @property
    def at_s(self) -> float:
        return self.at_ns / 1e9

    @property
    def value(self) -> float:
        if isinstance(self.raw, torch.Tensor):
            self.raw = float(self.raw)
        return float(self.raw)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Timed:
    """A span's context: reads the clock at both ends (``seconds``);
    keeps a record where ``keep``."""

    __slots__ = ("name", "device", "attrs", "keep", "rec", "start_ns",
                 "end_ns")

    def __init__(self, name: str, device, attrs: dict, keep: bool):
        self.name, self.device, self.attrs, self.keep = (name, device,
                                                         attrs, keep)
        self.rec = None

    def __enter__(self):
        if self.keep:
            stack = _stack()
            rec = self.rec = Span(self.name, next(_ids),
                                  stack[-1] if stack else None,
                                  threading.get_ident(), self.attrs, 0)
            stack.append(rec.id)
            if self.device is not None and self.device.type == "cuda":
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.events[0].record(torch.cuda.current_stream(self.device))
            _records.append(rec)
        self.start_ns = time.perf_counter_ns()
        if self.rec is not None:
            self.rec.start_ns = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record(torch.cuda.current_stream(self.device))
            _stack().pop()
            rec.end_ns = self.end_ns
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, *, device: torch.device | None = None, **attrs):
    """A context that records a span where recording is on, and
    otherwise does nothing.  ``device``: the device the region's work
    runs on; a CUDA device's interval is recorded too."""
    if not (_forced or _profiler._is_profiler_enabled) \
            or getattr(_local, "quiet", 0):
        return _NULL
    return _Timed(name, device, attrs, True)


def timed(name: str, **attrs):
    """As ``span`` (host time alone), for a caller that needs the
    region's time in any case: the context always reads the clock
    (``.seconds`` after it closes), and records where recording is on."""
    return _Timed(name, None, attrs, on())


def instant(name: str, **attrs) -> None:
    """A span of no length, now."""
    if on():
        stack = _stack()
        t = time.perf_counter_ns()
        _records.append(Span(name, next(_ids), stack[-1] if stack else None,
                             threading.get_ident(), attrs, t, t))


def count(name: str, value) -> None:
    """Add ``value`` (a number or a 0-d tensor, read later) to the
    counter ``name``, where recording is on."""
    if on():
        stack = _stack()
        _records.append(Count(name, time.perf_counter_ns(),
                              stack[-1] if stack else None,
                              threading.get_ident(), value))


def _inside(start_s: float, end_s: float, window) -> bool:
    return window is None or (window[0] <= start_s and end_s <= window[1])


def spans(window: tuple[float, float] | None = None) -> list[Span]:
    """The closed spans kept, in the order they started (on each thread);
    with ``window`` (perf_counter seconds), those lying inside it.  Each
    device interval is resolved here: this waits for the region's last
    work on the device."""
    out = []
    for r in list(_records):
        if not isinstance(r, Span) or not r.end_ns or \
                not _inside(r.start_s, r.end_s, window):
            continue
        if r.events is not None:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
        out.append(r)
    return out


def counts(window: tuple[float, float] | None = None) -> list[Count]:
    """The counter additions kept, in order; with ``window``, those made
    inside it."""
    return [r for r in list(_records) if isinstance(r, Count)
            and _inside(r.at_s, r.at_s, window)]


def clear() -> None:
    """Drop every record."""
    _records.clear()
