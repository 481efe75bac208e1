"""ScanSession — the client half of the hot-data serve plane.

The OSD-side :class:`~repro_torch.core.cache.ResultCache` makes a repeated
scan cheap; this layer makes it cheap *before* it ever reaches an OSD.
A :class:`ScanSession` fronts one :class:`~repro_torch.core.vol.GlobalVOL`
for a many-client workload and applies two dedup layers to the
concurrent scans admitted through it:

**Single-flight.**  Identical scans that overlap in time collapse into
ONE execution: the first arrival (the leader) runs the scan, every
later identical arrival (a joiner) parks on the flight and receives
the same result — N identical concurrent scans cost one OSD round
trip, fanned out N ways.  Identity is the scan's compiled pipeline
digest (``objclass.pipeline_digest`` over the serialized ops), so two
fluent chains that describe the same pipeline dedup even when built
independently.

**Column coalescing.**  Table-out scans that differ ONLY in their
projection share a flight too: during the admission window the
flight's column set grows to the union, the leader executes once with
the widened projection, and each waiter gets exactly its requested
columns sliced out — same-object different-column requests become one
request.  A scan arriving after the flight sealed still joins when its
columns are a subset of what is already in flight.

Results fan out by reference (column arrays are never copied), which
is safe for the same reason the OSD cache is: every layer of the scan
plane builds new dicts rather than mutating served tables.  Errors fan
out too — a failed flight raises the leader's exception in every
waiter.  The session itself adds no coherence hazard: dedup only ever
merges scans into one REAL execution against the store, so every
result a waiter sees was served (and version-checked) by the OSDs at
one point in time; there is no client-side result reuse across calls.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.core import objclass as oc


class _Flight:
    """One in-flight scan execution and the waiters parked on it."""

    __slots__ = ("cols", "sealed", "done", "result", "stats", "error",
                 "waiters")

    def __init__(self, cols: tuple[str, ...] | None):
        # the union of every joined waiter's projection; None for
        # non-coalescible flights (exact-pipeline dedup only)
        self.cols: set[str] | None = set(cols) if cols is not None \
            else None
        self.sealed = False      # column set frozen (leader is executing)
        self.done = threading.Event()
        self.result: Any = None  # full-union result (leader's output)
        self.stats: dict | None = None
        self.error: BaseException | None = None
        self.waiters = 1


class ScanSession:
    """Admission front-end for many concurrent clients scanning one vol.

    ``window_s`` is the admission window: a flight's leader holds the
    execution open that long so concurrent arrivals can join (and
    coalescible ones widen the projection) before the single OSD round
    trip goes out.  ``0`` disables the hold — single-flight dedup then
    only catches arrivals that overlap an execution already in flight.

    Thread-safe; meant to be shared across client threads.  ``stats``
    counts admissions/executions/dedups under the session lock::

        session = ScanSession(vol, window_s=0.002)
        result, stats = session.execute(vol.scan("ds").project("x"))
    """

    # lock-discipline contract: the flight table and the admission
    # counters are mutated by every client thread entering the session
    _GUARDED_BY = {"_flights": "_lock", "stats": "_lock"}

    def __init__(self, vol, *, window_s: float = 0.0):
        self.vol = vol
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._flights: dict[tuple, _Flight] = {}
        self.stats = {
            "admitted": 0,    # scans entering the session
            "executed": 0,    # real OSD executions issued
            "deduped": 0,     # scans served by joining a flight
            "coalesced": 0,   # joins that widened a flight's columns
            "solo": 0,        # sealed-flight misses run standalone
        }

    # ------------------------------------------------------------ keys
    @staticmethod
    def _identity(scan) -> tuple[tuple, tuple[str, ...] | None]:
        """``(flight_key, cols)``: the dedup key and, for coalescible
        scans, the projection kept OUT of the key so flights can merge
        columns.  Non-coalescible scans (aggregates, median, full-table
        reads) dedup on the exact pipeline instead (``cols`` None)."""
        coalescible = (scan.projection is not None
                       and not scan.aggregates
                       and scan.median_col is None)
        if coalescible:
            base = dataclasses.replace(scan, projection=None)
            return ((scan.dataset, scan.approx, scan.prune_strategy,
                     oc.pipeline_digest(base.pipeline()), "cols"),
                    tuple(scan.projection))
        return ((scan.dataset, scan.approx, scan.prune_strategy,
                 oc.pipeline_digest(scan.pipeline()), "exact"), None)

    # ------------------------------------------------------------ serve
    def execute(self, scan) -> tuple[Any, dict]:
        """Run one scan through the session: join an open (or still
        compatible) flight when one exists, otherwise lead a new one.
        Returns ``(result, stats)`` exactly like ``Scan.execute``."""
        scan = scan.bind(self.vol, scan._runner)
        key, cols = self._identity(scan)
        with self._lock:
            self.stats["admitted"] += 1
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight(cols)
                self._flights[key] = flight
                self.stats["executed"] += 1
                role = "lead"
            elif cols is None or not flight.sealed:
                # open flight: a coalescible joiner widens the union
                if cols is not None and not set(cols) <= flight.cols:
                    flight.cols |= set(cols)
                    self.stats["coalesced"] += 1
                flight.waiters += 1
                self.stats["deduped"] += 1
                role = "join"
            elif flight.cols is not None and set(cols) <= flight.cols:
                # sealed but already fetching a superset: pure dedup
                flight.waiters += 1
                self.stats["deduped"] += 1
                role = "join"
            else:
                # sealed flight fetching too little: run standalone
                # (re-keying the dict entry would strand its joiners)
                self.stats["solo"] += 1
                self.stats["executed"] += 1
                role = "solo"
        if role == "join":
            flight.done.wait()
            if flight.error is not None:
                raise flight.error
            return self._slice(flight.result, cols), dict(flight.stats)
        if role == "solo":
            return scan.execute()
        return self._lead(key, flight, scan, cols)

    def _lead(self, key: tuple, flight: _Flight, scan,
              cols) -> tuple[Any, dict]:
        if self.window_s > 0:
            time.sleep(self.window_s)  # admission window: concurrent
            #                            arrivals join before we seal
        with self._lock:
            flight.sealed = True
            union = tuple(sorted(flight.cols)) \
                if flight.cols is not None else None
        run = scan
        if union is not None and set(union) != set(cols):
            run = dataclasses.replace(scan, projection=union)
        try:
            flight.result, flight.stats = run.execute()
        except BaseException as e:
            flight.error = e
            raise
        finally:
            with self._lock:
                # pop BEFORE waking waiters: a scan arriving now must
                # lead a fresh execution, not adopt a finished one
                self._flights.pop(key, None)
            flight.done.set()
        return self._slice(flight.result, cols), dict(flight.stats)

    @staticmethod
    def _slice(result, cols) -> Any:
        if cols is None or not isinstance(result, dict):
            return result
        return {c: result[c] for c in cols}
