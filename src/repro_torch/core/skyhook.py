"""SkyhookDM-style driver/worker scheduling over the scan engine
(paper §4.2, Fig. 3/4).

Workflow (Fig. 4): a client submits a :class:`Query` (the declarative
shim) or a :class:`~repro_torch.core.scan.Scan` (the composable builder) ->
the Driver compiles it to ONE :class:`~repro_torch.core.scan.PhysicalPlan`
through the shared ``ScanEngine`` -> the plan's per-OSD request shards
are scheduled over Workers, which forward them to the storage
extensions (``exec_combine`` / ``exec_concat`` / ``exec_batch``) and
relay the per-OSD partials or framed tables back -> the engine combines
and emits the unified stats.

The Driver adds SCHEDULING only.  What to push down, how to prune
(OSD-side by default — the predicates ride inside the workers' batched
requests), and how to combine are all decided by the engine at compile
time; the driver/worker layer is a transport that must preserve the
store-call semantics.  This is exactly the paper's split: "Workers
could further conduct some complicated computations against the results
returned by Skyhook-Extensions", while the planning stays global.

``execute_client_side`` is the no-pushdown baseline (full objects to
the client, pipeline evaluated locally) — also compiled and executed by
the engine, as the ``client-gather`` execution class.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from repro_torch.core import objclass as oc
from repro_torch.core.scan import Scan
from repro_torch.core.store import ObjectStore
from repro_torch.core.vol import GlobalVOL


@dataclasses.dataclass(frozen=True)
class Query:
    """A declarative query against one mapped dataset — now a thin shim
    that compiles to a :class:`~repro_torch.core.scan.Scan`.

    ``filter`` accepts one ``(col, cmp, value)`` triple or a sequence
    of them; ``filters`` is the explicit N-ary spelling.  All filters
    AND together.  ``aggregate`` accepts one ``(fn, col)`` pair or a
    sequence of pairs (compiled to one mergeable ``multi_agg`` tail);
    ``fn`` may be ``"median"`` (holistic unless ``allow_approx``).
    """

    dataset: str
    filter: tuple | None = None            # (col, cmp, value) | sequence
    projection: tuple[str, ...] | None = None
    aggregate: tuple | None = None         # (fn, col) | sequence of them
    allow_approx: bool = False
    filters: tuple = ()                    # ((col, cmp, value), ...)

    def to_scan(self) -> Scan:
        s = Scan(dataset=self.dataset)
        flts = list(_nested(self.filter)) + list(self.filters)
        for col, cmp, value in flts:
            s = s.filter(col, cmp, value)
        if self.projection:
            s = s.project(*self.projection)
        for fn, col in _nested(self.aggregate):
            s = s.median(col, approx=self.allow_approx) \
                if fn == "median" else s.agg(fn, col)
        return s

    def pipeline(self) -> list[oc.ObjOp]:
        return self.to_scan().pipeline()


def _nested(spec) -> tuple:
    """Normalize None | one tuple | sequence-of-tuples to a tuple of
    tuples (how ``Query.filter``/``aggregate`` accept one or many)."""
    if not spec:
        return ()
    if isinstance(spec[0], (tuple, list)):
        return tuple(tuple(x) for x in spec)
    return (tuple(spec),)


@dataclasses.dataclass
class QueryStats:
    """Uniform per-query stats — emitted by the ONE engine, so every
    path (vol.query, driver, client-side baseline) reports pushdown,
    pruning, and cardinality identically.  ``result_rows`` is the
    result's cardinality: table rows for table-out scans, 1 for
    scalar/aggregate results (never None for a completed query)."""

    wall_s: float
    objects_touched: int
    objects_pruned: int
    client_rx_bytes: int
    storage_local_bytes: int
    pushdown: bool
    result_rows: int | None = None
    fabric_ops: int = 0        # client<->OSD round trips the query cost
    rx_frames: int = 0         # framed responses the client parsed
    exec_class: str = ""       # scan.EXEC_* the plan compiled to
    prune: str = ""            # prune strategy the plan compiled to

    @property
    def selectivity_gain(self) -> float:
        """How many storage-side bytes were scanned per byte returned."""
        return self.storage_local_bytes / max(self.client_rx_bytes, 1)


class SkyhookWorker:
    """Executes sub-requests against a set of objects via the storage
    extensions, relaying per-OSD partials / framed tables back."""

    def __init__(self, store: ObjectStore, worker_id: int):
        self.store = store
        self.worker_id = worker_id

    def run(self, names: list[str], ops, mode: str = "batch",
            predicates=None) -> Any:
        """Forward the shard as batched per-OSD objclass requests (one
        round trip per OSD this shard touches, not one per object).
        ``mode`` follows the engine's runner protocol: "combine" folds
        partials server-side, "concat" returns one framed table per
        OSD, "batch" returns per-object results.  ``predicates`` is the
        plan's filter-expression tree (or None), riding down serialized
        for OSD-side pruning."""
        if mode == "combine":
            got = self.store.exec_combine(names, ops, prune=predicates)
            return got if isinstance(got, tuple) else (got, [])
        if mode == "concat":
            return self.store.exec_concat(names, ops, prune=predicates)
        return self.store.exec_batch(names, ops)

    def run_stream(self, names: list[str], ops, predicates=None,
                   pruned_out: list | None = None):
        """Frame-streaming concat shard: an iterator of per-OSD framed
        responses, each yielded the MOMENT its OSD answers
        (``exec_concat_iter``) instead of after the whole shard — so
        the driver forwards frames at OSD granularity and one slow OSD
        in a shard no longer gates that shard's fast frames.
        ``pruned_out`` accumulates OSD-pruned names, complete once the
        iterator is exhausted."""
        return self.store.exec_concat_iter(names, ops, prune=predicates,
                                           pruned_out=pruned_out)


class SkyhookDriver:
    """Schedules a compiled plan's shards over workers; the engine does
    the planning and the combining."""

    def __init__(self, vol: GlobalVOL, n_workers: int = 4):
        self.vol = vol
        self.store = vol.store
        self.workers = [SkyhookWorker(self.store, i)
                        for i in range(n_workers)]
        # persistent dispatch pool (mirrors ObjectStore._pool): no
        # per-query executor churn on the hot path
        self._pool = ThreadPoolExecutor(max_workers=n_workers,
                                        thread_name_prefix="skyhook-drv")

    def close(self) -> None:
        """Stop the dispatch pool; returns once its threads have finished
        what they run (queued shards are cancelled), so no decode on the
        card outlives the driver."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        try:
            self._pool.shutdown(wait=False)
        except Exception:
            pass

    # ------------------------------------------------------------ execute
    def scan(self, dataset: str) -> Scan:
        """A fluent scan whose ``execute`` is scheduled by this driver
        (the plan executes through ``_runner``, i.e. the workers)."""
        return Scan(dataset=dataset).bind(self.vol, runner=self._runner)

    def execute(self, q: Query | Scan) -> tuple[Any, QueryStats]:
        s = q.to_scan() if isinstance(q, Query) else q
        omap = self.vol.open(s.dataset)
        t0 = time.perf_counter()
        before = self.store.fabric.snapshot()  # include compile traffic
        plan = self.vol.engine.compile(omap, s)
        result, vstats = self.vol.engine.execute(
            plan, runner=self._runner, before=before, omap=omap)
        return result, self._stats(vstats, t0)

    # ------------------------------------------------------------ baseline
    def execute_client_side(self, q: Query | Scan) -> tuple[Any, QueryStats]:
        """The no-pushdown baseline: fetch every object's full bytes to
        the client and evaluate the pipeline locally (the engine's
        ``client-gather`` execution class)."""
        s = q.to_scan() if isinstance(q, Query) else q
        omap = self.vol.open(s.dataset)
        t0 = time.perf_counter()
        before = self.store.fabric.snapshot()
        plan = self.vol.engine.compile_ops(omap, s.pipeline(),
                                           baseline=True)
        result, vstats = self.vol.engine.execute(plan, before=before)
        return result, self._stats(vstats, t0)

    # ------------------------------------------------------------ internals
    def _stats(self, vstats: dict, t0: float) -> QueryStats:
        return QueryStats(
            wall_s=time.perf_counter() - t0,
            objects_touched=vstats["objects_touched"],
            objects_pruned=vstats["objects_pruned"],
            client_rx_bytes=vstats["client_rx"],
            storage_local_bytes=vstats["local_bytes"],
            pushdown=vstats["pushdown"],
            result_rows=vstats["result_rows"],
            fabric_ops=vstats["ops"],
            rx_frames=vstats["rx_frames"],
            exec_class=vstats["exec_class"],
            prune=vstats["prune"],
        )

    def _runner(self, mode: str, names: list[str], pipelines,
                predicates=None, plan_shards: tuple = ()) -> Any:
        """The engine's runner, scheduled over workers: the plan's
        per-OSD shards (each OSD's objects stay in ONE worker's batch,
        so the whole query still costs <= K batched requests for K OSDs
        regardless of worker count) round-robin across workers, then
        shard-local results translate back to global positions."""
        shared = not pipelines or isinstance(pipelines[0], oc.ObjOp)
        if not plan_shards:  # derive placement if the plan carries none
            by_osd: dict[str, list[int]] = {}
            for i, n in enumerate(names):
                by_osd.setdefault(
                    self.store.cluster.primary(n), []).append(i)
            plan_shards = tuple(sorted(by_osd.items()))
        shards: list[list[int]] = [[] for _ in self.workers]
        for j, (_, idxs) in enumerate(plan_shards):
            shards[j % len(self.workers)].extend(idxs)

        def run_shard(pair):
            w, idxs = pair
            if not idxs:
                return idxs, ([] if mode == "batch" else ([], []))
            sub_names = [names[i] for i in idxs]
            sub_pipes = pipelines if shared \
                else [pipelines[i] for i in idxs]
            return idxs, w.run(sub_names, sub_pipes, mode=mode,
                               predicates=predicates)

        io = self.store.io_simulated()
        if mode == "batch":
            if io:  # workers overlap simulated I/O
                outs = list(self._pool.map(run_shard,
                                           zip(self.workers, shards)))
            else:  # compute-bound: threads only add GIL contention
                outs = [run_shard(p) for p in zip(self.workers, shards)]
            results: list[Any] = [None] * len(names)
            for idxs, rs in outs:
                for i, r in zip(idxs, rs):
                    results[i] = r
            return results

        # combine/concat follow the engine's LAZY runner protocol: the
        # partial/frame half streams as results land (the engine
        # decodes early results while slower OSDs are still scanning);
        # ``pruned`` fills during consumption and is complete once the
        # stream is exhausted
        pruned: list[str] = []

        if mode == "concat":
            return self._concat_stream(names, pipelines, shared,
                                       predicates, shards, io,
                                       pruned), pruned

        # combine partials feed an order-sensitive float fold and keep
        # submission order (deterministic); they are scalar-sized, so
        # there is no decode to overlap anyway
        def stream():
            if io:
                futs = [self._pool.submit(run_shard, p)
                        for p in zip(self.workers, shards)]
                for f in futs:
                    idxs, (items, pr) = f.result()
                    pruned.extend(pr)
                    yield from items
            else:
                for p in zip(self.workers, shards):
                    idxs, (items, pr) = run_shard(p)
                    pruned.extend(pr)
                    yield from items

        return stream(), pruned

    def _concat_stream(self, names, pipelines, shared, predicates,
                       shards, io, pruned):
        """Worker-level frame streaming: every per-OSD framed response
        forwards the moment it lands, translated to global positions —
        frames interleave ACROSS workers in arrival order (matching the
        store-direct ``exec_concat_iter`` overlap), not in
        shard-completion order, so one slow OSD anywhere delays only
        its own frame."""
        work = []  # (worker, global idxs) pairs with actual items
        for w, idxs in zip(self.workers, shards):
            if idxs:
                sub_pipes = pipelines if shared \
                    else [pipelines[i] for i in idxs]
                work.append((w, idxs, [names[i] for i in idxs],
                             sub_pipes))

        if not io:  # compute-bound: sequential, still frame-granular
            def stream_seq():
                for w, idxs, sub_names, sub_pipes in work:
                    local_pruned: list[str] = []
                    for local, blob, counts in w.run_stream(
                            sub_names, sub_pipes, predicates,
                            local_pruned):
                        yield (tuple(idxs[k] for k in local), blob,
                               counts)
                    pruned.extend(local_pruned)
            return stream_seq()

        # one pump per worker shard feeds a shared arrival queue; the
        # consumer (the engine, decoding frames) runs on the caller's
        # thread and drains until every pump posts its done sentinel
        q: _queue.Queue = _queue.Queue()

        def pump(w, idxs, sub_names, sub_pipes):
            local_pruned: list[str] = []
            try:
                for local, blob, counts in w.run_stream(
                        sub_names, sub_pipes, predicates, local_pruned):
                    q.put(("frame",
                           (tuple(idxs[k] for k in local), blob,
                            counts)))
            except BaseException as e:
                q.put(("error", e))
                return
            q.put(("done", local_pruned))

        futs = [self._pool.submit(pump, *item) for item in work]

        def stream_live():
            live = len(futs)
            while live:
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                if kind == "done":
                    pruned.extend(payload)
                    live -= 1
                    continue
                yield payload

        return stream_live()
