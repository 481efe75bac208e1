"""Composable scan API — ONE plan→compile→execute surface (paper §3.2).

The paper's promise is *composability of access operations* over an
object-mapped dataset.  This module is where that promise lives:

  * :class:`Scan` — a fluent, immutable logical plan.  Filters compose
    as a predicate-expression tree (``.filter`` ANDs a comparison;
    ``.or_``/``.isin``/``.filter_expr`` AND OR-groups, IN-lists,
    ranges, string prefixes, negations — ``core.expr``), aggregates
    compose side by side, a holistic median can opt into its
    decomposable sketch approximation, and a row range restricts the
    scan — all independent of how anything executes::

        vol.scan("events").or_(("run", "<", 10), ("run", ">", 90)) \\
                          .filter("hits", ">=", 3) \\
                          .agg("mean", "e_pt").agg("count", "e_pt") \\
                          .execute()

  * :class:`PhysicalPlan` — what a ``Scan`` compiles to: the storage
    pipeline, the prune strategy, the execution class, and the per-OSD
    request shards.  ``Scan.explain()`` returns it for inspection.

  * :class:`ScanEngine` — the ONE executor.  ``GlobalVOL.read`` /
    ``GlobalVOL.query``, ``SkyhookDriver.execute`` (and its client-side
    baseline), and the training-data loader all route through it; the
    tail/combine/holistic/approx-rewrite decision exists nowhere else.

Execution classes
-----------------
``osd-combine``      mergeable aggregate tails: each OSD folds its local
                     partials (``exec_combine``) — client_rx O(K).
``server-concat``    table-out pipelines: each OSD concatenates its
                     result tables into ONE framed block
                     (``exec_concat``) — rx_frames O(K).
``holistic-gather``  exact median: filters/projection still run
                     storage-side (as a server-concat of the projected
                     column), the holistic tail runs client-side.
``table-gather``     per-object raw results (e.g. zero-decode
                     ``select_packed``) via ``exec_batch``.
``client-gather``    the no-pushdown baseline: full objects to the
                     client, pipeline evaluated locally.

Prune strategies
----------------
``pushdown`` (default): the serialized predicate tree rides inside the
batched objclass request and each OSD prunes against its own CURRENT
zone-map xattrs — zero client zone-map requests, and no plan→execute
TOCTOU window (the OSD can never see a stale zone map).  ``client``:
the classic cached-zone-map prune with version-tag revalidation
(``GlobalVOL.plan``) — kept for workloads that want to skip whole OSD
round trips when everything prunes.  ``none``: scan everything.  Both
strategies share one prune rule (``objclass.zone_map_prunes`` over the
same expression tree), so on identical metadata they prune identical
sets — including ``Or``-of-disjoint-ranges sets no flat conjunction
could prune.

Row ranges ship OSD-side too: ``.rows()`` compiles to a ``row_slice``
op carrying GLOBAL dataset rows; each OSD resolves its objects'
sub-ranges from their own extent (``rows``) xattrs at execute time, so
one compiled plan keeps serving correct rows after the dataset is
re-partitioned under it — and a row-ranged aggregate now rides the
per-OSD combine plane (shared pipeline) instead of per-object gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.core import expr as ex
from repro_torch.core import format as fmt
from repro_torch.core import objclass as oc
from repro_torch.core.logical import (Dataspace, Hyperslab, RowRange,
                                concat_tables)
from repro_torch.core.partition import objmap_key

EXEC_OSD_COMBINE = "osd-combine"
EXEC_SERVER_CONCAT = "server-concat"
EXEC_HOLISTIC_GATHER = "holistic-gather"
EXEC_TABLE_GATHER = "table-gather"
EXEC_PARTIAL_GATHER = "partial-gather"
EXEC_CLIENT_GATHER = "client-gather"

PRUNE_STRATEGIES = ("auto", "pushdown", "client", "none")
_AGG_FNS = ("sum", "count", "min", "max", "mean")


# --------------------------------------------------------------------------
# Scan — the fluent logical plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scan:
    """An immutable, composable scan description.

    Every fluent call returns a NEW ``Scan`` (the receiver is never
    mutated), so partial scans are safely shareable::

        base = vol.scan("events").filter("run", "<", 50)
        a, _ = base.agg("mean", "e_pt").execute()
        b, _ = base.project("e_pt").execute()

    A ``Scan`` built through ``GlobalVOL.scan`` is *bound* (it knows its
    vol and can ``explain()``/``execute()`` itself); a bare
    ``Scan(dataset=...)`` is a pure value that a driver executes.
    """

    dataset: str | None = None
    predicate: Any = None                   # expr.Expr | None (filter tree)
    projection: tuple[str, ...] | None = None
    aggregates: tuple = ()                  # ((fn, col), ...)
    median_col: str | None = None
    approx: bool = False
    row_range: tuple[int, int] | None = None
    prune_strategy: str = "auto"
    _vol: Any = dataclasses.field(default=None, compare=False, repr=False)
    _runner: Any = dataclasses.field(default=None, compare=False,
                                     repr=False)

    # ------------------------------------------------------------ fluent
    def filter(self, col: str, cmp: str, value) -> "Scan":
        """AND a comparison into the scan's predicate tree."""
        return self.filter_expr(ex.Cmp(col, cmp, value))

    def filter_expr(self, e) -> "Scan":
        """AND an arbitrary predicate expression into the scan: an
        ``expr`` tree (``And``/``Or``/``Not``/``Cmp``/``In``/
        ``Between``/``StrPrefix``), its serialized dict, or a
        ``(col, cmp, value)`` triple."""
        return dataclasses.replace(
            self, predicate=ex.conj(self.predicate, ex.ensure(e)))

    def or_(self, *alternatives) -> "Scan":
        """AND an OR-group of alternatives into the scan::

            scan.or_(("run", "<", 10), ("run", ">", 90))

        Each alternative is an expression or a (col, cmp, value)
        triple.  The whole group prunes an object only when EVERY
        alternative's interval proof empties it."""
        if len(alternatives) < 2:
            raise ValueError("or_ needs at least two alternatives")
        return self.filter_expr(
            ex.Or(tuple(ex.ensure(a) for a in alternatives)))

    def isin(self, col: str, values) -> "Scan":
        """AND an IN-list membership predicate into the scan."""
        return self.filter_expr(ex.In(col, tuple(values)))

    def project(self, *cols: str) -> "Scan":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        if not cols:
            raise ValueError("project needs at least one column")
        return dataclasses.replace(self, projection=tuple(cols))

    def agg(self, fn: str, col: str) -> "Scan":
        """Add an aggregate; N aggregates compile to ONE mergeable
        ``multi_agg`` tail (still one partial per OSD)."""
        if fn == "median":
            return self.median(col)
        if fn not in _AGG_FNS:
            raise ValueError(f"bad aggregate {fn!r}; known: {_AGG_FNS} "
                             "(median via .median())")
        if self.median_col is not None:
            raise ValueError("median is holistic; it cannot compose "
                             "with other aggregates in one scan")
        return dataclasses.replace(
            self, aggregates=self.aggregates + ((fn, col),))

    def median(self, col: str, *, approx: bool = False) -> "Scan":
        """Exact median (holistic gather) or, with ``approx=True``, its
        decomposable quantile-sketch rewrite (paper §3.2)."""
        if self.aggregates:
            raise ValueError("median is holistic; it cannot compose "
                             "with other aggregates in one scan")
        return dataclasses.replace(self, median_col=col, approx=approx)

    def rows(self, rows, stop: int | None = None) -> "Scan":
        """Restrict the scan to a row range: ``.rows(RowRange(a, b))``
        or ``.rows(a, b)``."""
        if stop is not None:
            rows = RowRange(int(rows), int(stop))
        elif not isinstance(rows, RowRange):
            rows = RowRange(*rows)
        return dataclasses.replace(self, row_range=(rows.start, rows.stop))

    def prune(self, strategy: str) -> "Scan":
        if strategy not in PRUNE_STRATEGIES:
            raise ValueError(f"bad prune strategy {strategy!r}; "
                             f"known: {PRUNE_STRATEGIES}")
        return dataclasses.replace(self, prune_strategy=strategy)

    def bind(self, vol, runner=None) -> "Scan":
        """Attach the executing vol (and optionally a scheduling runner
        — e.g. a driver's worker dispatcher) to this scan."""
        return dataclasses.replace(self, _vol=vol, _runner=runner)

    # ------------------------------------------------------------ compile
    def pipeline(self) -> list[oc.ObjOp]:
        """The logical objclass pipeline this scan describes: a row
        range ships as a ``row_slice`` op (GLOBAL rows, resolved per
        object ON the OSD from its extent xattr) and the whole filter
        tree ships serialized inside ONE ``filter`` op's params."""
        ops: list[oc.ObjOp] = []
        if self.row_range is not None:
            ops.append(oc.op("row_slice", rows=tuple(self.row_range)))
        if self.predicate is not None:
            ops.append(oc.op("filter", expr=self.predicate.to_json()))
        if self.projection:
            ops.append(oc.op("project", cols=list(self.projection)))
        if self.median_col is not None:
            ops.append(oc.op("median", col=self.median_col))
        elif len(self.aggregates) == 1:
            fn, col = self.aggregates[0]
            ops.append(oc.op("agg", col=col, fn=fn))
        elif self.aggregates:
            ops.append(oc.op("multi_agg", specs=tuple(self.aggregates)))
        return ops

    def _bound(self, omap=None):
        if self._vol is None:
            raise ValueError("unbound Scan — build it via vol.scan(...) "
                             "or hand it to a SkyhookDriver")
        if omap is None:
            omap = self._vol.open(self.dataset)
        return self._vol.engine, omap

    def explain(self, omap=None) -> "PhysicalPlan":
        engine, omap = self._bound(omap)
        return engine.compile(omap, self)

    def execute(self, omap=None) -> tuple[Any, dict]:
        engine, omap = self._bound(omap)
        before = self._vol.store.fabric.snapshot()
        return engine.execute(engine.compile(omap, self),
                              runner=self._runner, before=before,
                              omap=omap)


def scan(dataset: str) -> Scan:
    """An unbound scan over a named dataset (bind via a vol/driver)."""
    return Scan(dataset=dataset)


# --------------------------------------------------------------------------
# PhysicalPlan — what a Scan compiles to
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    """The compiled form of one scan: what ships, where, and how the
    results come back.  Frozen — executing a plan never mutates it, so
    a plan can be compiled once and executed many times (each execution
    re-reads CURRENT storage state; under ``prune="pushdown"`` even the
    prune decisions are made at execute time, on the OSDs)."""

    dataset: str
    exec_cls: str                    # one of the EXEC_* classes
    prune: str                       # "pushdown" | "client" | "none"
    names: tuple[str, ...]           # kept sub-requests, global row order
    ops: tuple[oc.ObjOp, ...]        # the logical pipeline
    exec_ops: tuple[oc.ObjOp, ...]   # what actually ships (holistic tails
    #                                  ship their projected-gather form)
    pipelines: tuple | None = None   # per-object pipelines (loader
    #                                  runs); None = shared exec_ops
    predicates: Any = None           # expr.Expr tree pushed to the OSDs
    #                                  when prune == "pushdown"
    pruned: tuple[str, ...] = ()     # client-side pruned at compile time
    shards: tuple = ()               # ((osd_id, (name idx, ...)), ...)
    pushdown: bool = False           # pipeline ops run storage-side?
    approx_rewrite: bool = False
    assemble: str = "table"          # "table" | "parts" (loader) |
    #                                  "array" (N-d hyperslab result)
    access: str | None = None        # LocalVOL access-stats kind
    n_objects: int = 0               # dataset size before pruning
    omap_version: int = -1           # store version of the ObjectMap the
    #                                  plan compiled against (-1 unknown):
    #                                  row-sliced plans re-derive ``names``
    #                                  at execute time when the map moved
    array_meta: Any = None           # hyperslab plans: {"space", "sel",
    #                                  "squeeze", "fill"} — what client
    #                                  assembly (and the targeting
    #                                  refresh) needs to rebuild the N-d
    #                                  result from chunk-id-tagged cells


# --------------------------------------------------------------------------
# ScanEngine — the one executor
# --------------------------------------------------------------------------


class ScanEngine:
    """Compiles scans/pipelines to :class:`PhysicalPlan` and executes
    them against the store.

    ``execute`` takes an optional ``runner`` — the driver passes a
    worker-sharding dispatcher (Fig. 4), everything else uses the
    store's own per-OSD batch plane directly.  A runner is transport
    only: it must preserve the store-call semantics, never re-decide
    the plan.

    Runner protocol: ``runner(mode, names, pipelines, predicates,
    shards)`` where mode is ``"combine"`` → ``(partials,
    pruned_names)``, ``"concat"`` → ``(frames, pruned_names)`` with
    frames ``(global_indices, blob, row_counts)``, or ``"batch"`` →
    per-object results aligned with ``names``.  ``shards`` is the
    plan's per-OSD grouping (``(osd_id, name_indices)`` pairs) so a
    scheduling runner need not re-derive placement.

    The ``partials`` / ``frames`` half of a combine/concat response may
    be LAZY — an iterator that yields per-OSD results as they land
    (the store's ``exec_*_iter`` planes, or a driver streaming shard
    results in worker-completion order).  The engine consumes it
    frame-by-frame, decoding/folding each result while slower OSDs are
    still scanning, and reads ``pruned_names`` (which may fill during
    iteration) only after exhaustion.
    """

    def __init__(self, vol):
        self.vol = vol

    # ------------------------------------------------------------ compile
    def compile(self, omap, scan: Scan) -> PhysicalPlan:
        return self._compile(omap, scan.pipeline(),
                             allow_approx=scan.approx,
                             prune=scan.prune_strategy)

    def compile_ops(self, omap, ops: Sequence[oc.ObjOp], *,
                    allow_approx: bool = False, prune: str = "auto",
                    baseline: bool = False) -> PhysicalPlan:
        """Compile a raw objclass pipeline (the ``GlobalVOL.query`` /
        ``Query`` shim entry point)."""
        return self._compile(omap, list(ops), allow_approx=allow_approx,
                             prune=prune, baseline=baseline)

    def compile_read(self, omap, rows: RowRange,
                     columns: Sequence[str] | None = None) -> PhysicalPlan:
        ops = [oc.op("row_slice", rows=(rows.start, rows.stop))]
        if columns is not None:
            ops.append(oc.op("project", cols=list(columns)))
        return self._compile(omap, ops, access="fetch")

    def _compile(self, omap, ops, *, allow_approx=False,
                 prune="auto", baseline=False, access=None) -> PhysicalPlan:
        if prune not in PRUNE_STRATEGIES:
            raise ValueError(f"bad prune strategy {prune!r}; "
                             f"known: {PRUNE_STRATEGIES}")
        ops = list(ops)
        rows = None
        for o in ops:
            if o.name == "row_slice":
                g0, g1 = o.params["rows"]
                # clamp BOTH ends: a range wholly past the dataset is
                # an empty scan (no candidates), not a compile error
                stop = max(0, min(int(g1), omap.dataset.n_rows))
                rows = RowRange(min(max(0, int(g0)), stop), stop)
        rewritten = False
        if ops and ops[-1].name == "median" and allow_approx \
                and not baseline:
            col = ops[-1].params["col"]
            lo, hi = self.vol._column_bounds(omap, col)
            ops[-1] = oc.op("quantile_sketch", col=col, lo=lo, hi=hi)
            rewritten = True
        predicates = oc.filter_predicates(ops)

        tail = oc.get_impl(ops[-1].name) if ops else None
        if baseline:
            exec_cls = EXEC_CLIENT_GATHER
        elif tail is not None and not tail.table_out:
            if tail.combine is None:
                exec_cls = EXEC_HOLISTIC_GATHER
            elif oc.pipeline_mergeable(ops):
                exec_cls = EXEC_OSD_COMBINE
            else:  # partial tail the OSD cannot fold
                exec_cls = EXEC_PARTIAL_GATHER
        else:
            exec_cls = EXEC_SERVER_CONCAT

        # request targeting: a row range restricts the scan to the
        # objects its CURRENT omap says intersect; the row_slice op
        # itself still rides to the OSDs, each of which re-resolves its
        # objects' sub-ranges from their own extent xattrs at execute
        # time (a re-partitioned object serves its current rows)
        if rows is not None:
            subs = omap.lookup(rows)
            names = [e.name for e, _ in subs]
        else:
            names = [e.name for e in omap]

        if baseline and rows is not None:
            # the client baseline gathers whole candidate objects in row
            # order, so the global slice becomes one plain select over
            # their concatenated rows
            base = subs[0][0].row_start if subs else 0
            ops = [oc.op("select", rows=(rows.start - base,
                                         rows.stop - base))
                   if o.name == "row_slice" else o for o in ops]

        if exec_cls == EXEC_HOLISTIC_GATHER:
            # ship the projected-gather form; the holistic tail itself
            # runs client-side over the gathered column
            col = ops[-1].params["col"]
            exec_ops = tuple(ops[:-1]) + (oc.op("project", cols=[col]),)
        else:
            exec_ops = tuple(ops)

        # partial-gather's positional response cannot carry OSD prune
        # info.  "auto" falls back to the client-side planner; an
        # EXPLICIT "pushdown" request must not be silently served with
        # the weaker (TOCTOU-prone) strategy — refuse instead.
        if exec_cls == EXEC_PARTIAL_GATHER and prune == "pushdown" \
                and predicates is not None:
            raise ValueError(
                "prune='pushdown' cannot serve a partial-gather plan "
                "(per-object positional responses carry no OSD prune "
                "info); use prune='auto'/'client'")

        pruned: tuple[str, ...] = ()
        if baseline or predicates is None or prune == "none":
            prune_s = "none"
        elif prune == "client" or exec_cls == EXEC_PARTIAL_GATHER:
            # client-side prune, restricted to THIS scan's candidate
            # objects (a row-ranged scan must not warm/revalidate zone
            # maps for the rest of the dataset)
            plan0 = self.vol.plan(omap, ops, names=names)
            kept = {n for n, _ in plan0.sub_requests}
            pruned = tuple(n for n in names if n not in kept)
            names = [n for n in names if n in kept]
            prune_s = "client"
        else:
            prune_s = "pushdown"

        if access is None and exec_cls in (EXEC_OSD_COMBINE,
                                           EXEC_PARTIAL_GATHER):
            access = "scan"

        by_osd: dict[str, list[int]] = {}
        if not baseline:
            cluster = self.vol.store.cluster
            for i, n in enumerate(names):
                by_osd.setdefault(cluster.primary(n), []).append(i)

        return PhysicalPlan(
            dataset=omap.dataset.name,
            exec_cls=exec_cls,
            prune=prune_s,
            names=tuple(names),
            ops=tuple(ops),
            exec_ops=exec_ops,
            pipelines=None,
            predicates=predicates if prune_s == "pushdown" else None,
            pruned=pruned,
            shards=tuple(sorted(
                (osd, tuple(idxs)) for osd, idxs in by_osd.items())),
            pushdown=exec_cls in (
                EXEC_OSD_COMBINE, EXEC_SERVER_CONCAT,
                EXEC_PARTIAL_GATHER, EXEC_TABLE_GATHER),
            approx_rewrite=rewritten,
            access=access,
            n_objects=omap.n_objects,
            omap_version=getattr(omap, "version", -1),
        )

    def compile_hyperslab(self, amap, hs: Hyperslab, *, where=None,
                          fill=0, prune: str = "auto") -> PhysicalPlan:
        """Compile an N-d hyperslab selection over a chunked array map
        (``partition.ArrayObjectMap``) into a ``hyperslab_slice``
        pipeline on the server-concat plane.

        The op carries only the plan-constant geometry (dataspace +
        normalized selection); each OSD resolves it against its
        objects' CURRENT ``chunks`` extent xattrs at execute time —
        the same late-binding contract as ``row_slice``, so a compiled
        plan keeps serving correct cells after the array is
        re-partitioned.  ``where`` is a predicate over the cell values
        (column name ``data``): it ships as the request's pushdown
        prune tree (normalized — ``expr.normalize``) and each OSD drops
        whole chunks against its per-chunk zone-map xattrs before any
        cell moves; dropped chunks surface as ``fill`` in the assembled
        result.  Zero client zone-map requests either way."""
        if prune not in PRUNE_STRATEGIES:
            raise ValueError(f"bad prune strategy {prune!r}; "
                             f"known: {PRUNE_STRATEGIES}")
        if prune == "client":
            raise ValueError(
                "hyperslab plans prune per chunk ON the OSDs (per-chunk "
                "zone maps are storage-side state); use prune="
                "'auto'/'pushdown'/'none'")
        space = amap.space
        pred = ex.normalize(ex.ensure_pred(where)) \
            if prune != "none" else None
        targets = amap.lookup(hs)
        names = [e.name for e, _ in targets]
        by_osd: dict[str, list[int]] = {}
        cluster = self.vol.store.cluster
        for i, n in enumerate(names):
            by_osd.setdefault(cluster.primary(n), []).append(i)
        ops = (oc.op("hyperslab_slice", space=space.to_json(),
                     sel=hs.to_json()),)
        return PhysicalPlan(
            dataset=space.name,
            exec_cls=EXEC_SERVER_CONCAT,
            prune="pushdown" if pred is not None else "none",
            names=tuple(names),
            ops=ops,
            exec_ops=ops,
            predicates=pred,
            shards=tuple(sorted(
                (osd, tuple(idxs)) for osd, idxs in by_osd.items())),
            pushdown=True,
            assemble="array",
            access="fetch",
            n_objects=amap.n_objects,
            omap_version=getattr(amap, "version", -1),
            array_meta={"space": space.to_json(), "sel": hs.to_json(),
                        "squeeze": tuple(hs.squeeze), "fill": fill},
        )

    def compile_gather(self, names: Sequence[str],
                       pipelines: Sequence[Sequence[oc.ObjOp]],
                       packed: bool = False) -> PhysicalPlan:
        """Per-object sub-request gather (the data loader's plan):
        table-out pipelines ride the server-concat plane (one framed
        response per OSD); packed pipelines (``select_packed`` emits raw
        word partials, not tables) gather per object."""
        return PhysicalPlan(
            dataset="", prune="none",
            exec_cls=EXEC_TABLE_GATHER if packed else EXEC_SERVER_CONCAT,
            names=tuple(names), ops=(), exec_ops=(),
            pipelines=tuple(tuple(p) for p in pipelines),
            assemble="parts", pushdown=True, n_objects=len(names))

    # ------------------------------------------------------------ execute
    def _refresh(self, plan: PhysicalPlan, omap) -> PhysicalPlan:
        """Row-slice targeting refresh (ROADMAP standing item): a
        compiled plan's ``names`` were derived from the ObjectMap it
        compiled against.  The pushed-down ``row_slice`` already keeps
        re-partitioned objects serving their CURRENT rows, but an
        object whose extent GREW into the range after a re-partition
        was never targeted at compile time and would silently be
        skipped.  So before executing a row-sliced plan, compare its
        stamped map version against the current one — the caller's
        ``omap`` hint when it has one (free), else ONE xattr probe of
        ``<dataset>/.objmap`` — and recompile the plan from the fresh
        map when the version moved."""
        if plan.omap_version < 0 or not plan.dataset \
                or plan.exec_cls == EXEC_CLIENT_GATHER \
                or not any(o.name in ("row_slice", "hyperslab_slice")
                           for o in plan.ops):
            return plan
        hint_v = getattr(omap, "version", -1) if omap is not None else -1
        if hint_v == plan.omap_version:
            return plan  # executing against the map it compiled from
        if hint_v >= 0:
            current_v, fresh = hint_v, omap
        else:
            key = objmap_key(plan.dataset)
            current_v = int(self.vol.store.xattr(key)
                            .get("version", -1))
            fresh = None
        if current_v == plan.omap_version:
            return plan
        if fresh is None:
            fresh = self.vol.open(plan.dataset)
        if plan.array_meta is not None:
            # hyperslab plans re-target from the fresh chunk map; the
            # predicate (already normalized at first compile) and fill
            # ride along unchanged
            return self.compile_hyperslab(
                fresh, Hyperslab.from_json(plan.array_meta["sel"]),
                where=plan.predicates,
                fill=plan.array_meta.get("fill", 0),
                prune=plan.prune if plan.predicates is not None
                else "none")
        return self._compile(fresh, list(plan.ops),
                             prune=plan.prune, access=plan.access)

    def execute(self, plan: PhysicalPlan, runner=None,
                before: dict | None = None, omap=None) -> tuple[Any, dict]:
        """Run one compiled plan; returns ``(result, stats)`` with the
        unified stats emission every caller shares.  ``before`` lets the
        caller open the fabric-accounting window ahead of ``compile`` so
        the reported cost includes compile-time traffic (the client
        strategy's zone-map warm/revalidation, the approx rewrite's
        column-bounds fetch) — every query front end passes it.
        ``omap`` is a currency hint for the row-slice targeting refresh:
        callers that just compiled against a map they hold pass it so a
        matching version skips the refresh probe entirely."""
        store = self.vol.store
        run = runner or self._direct
        if before is None:
            before = store.fabric.snapshot()
        plan = self._refresh(plan, omap)
        names = list(plan.names)
        ops = list(plan.ops)
        pipes = [list(p) for p in plan.pipelines] \
            if plan.pipelines is not None else list(plan.exec_ops)
        preds = plan.predicates
        osd_pruned: list[str] = []
        result_rows: int | None = None

        shards = plan.shards

        if plan.exec_cls == EXEC_OSD_COMBINE:
            partials_src, pruned_src = run("combine", names, pipes,
                                           preds, shards)
            # consume lazily: each OSD's partial folds in as it lands
            partials = list(partials_src)
            osd_pruned = list(pruned_src)
            result = oc.combine_partials(ops, partials)
            result_rows = 1
        elif plan.exec_cls == EXEC_PARTIAL_GATHER:
            raw = run("batch", names, pipes, None, shards)
            result = oc.combine_partials(ops, raw)
            result_rows = 1
        elif plan.exec_cls == EXEC_HOLISTIC_GATHER:
            col = ops[-1].params["col"]
            frames_src, pruned_src = run("concat", names, pipes, preds,
                                         shards)
            # frame-by-frame: decode each OSD's block on arrival, while
            # slower OSDs are still scanning
            cols = [{col: fmt.decode_block(blob)[col].ravel()}
                    for _, blob, _ in frames_src]
            osd_pruned = list(pruned_src)
            result = oc.median_exact(cols, col)
            result_rows = 1
        elif plan.exec_cls == EXEC_SERVER_CONCAT:
            frames_src, pruned_src = run("concat", names, pipes, preds,
                                         shards)
            parts: list = [None] * len(names)
            for frame in frames_src:  # decode overlaps slower OSDs
                _place_frame(parts, frame)
            osd_pruned = list(pruned_src)
            if plan.assemble == "parts":
                result = parts
            elif plan.assemble == "array":
                result = _assemble_array(plan, parts)
                result_rows = int(result.size)
            else:
                result = concat_tables(
                    [p for p in parts if p is not None])
                result_rows = oc.table_n_rows(result)
        elif plan.exec_cls == EXEC_TABLE_GATHER:
            result = run("batch", names, pipes, None, shards)
        elif plan.exec_cls == EXEC_CLIENT_GATHER:
            result = self._client_eval(names, ops)
            result_rows = _result_rows(ops, result)
        else:
            raise ValueError(f"unknown execution class {plan.exec_cls!r}")

        if plan.access is not None:
            scanned = len(names) - len(osd_pruned)
            for _ in range(scanned):
                self.vol.local.note_access(plan.access)

        after = store.fabric.snapshot()
        stats = {k: after[k] - before[k] for k in after}
        stats.update(
            objects_touched=len(names) - len(osd_pruned),
            objects_pruned=len(plan.pruned) + len(osd_pruned),
            pushdown=plan.pushdown,
            approx_rewrite=plan.approx_rewrite,
            exec_class=plan.exec_cls,
            prune=plan.prune,
            result_rows=result_rows,
        )
        return result, stats

    def fetch_objects(self, names: Sequence[str],
                      pipelines: Sequence[Sequence[oc.ObjOp]],
                      packed: bool = False) -> list:
        """Execute a per-object gather plan and return per-object
        results aligned with ``names`` (decoded tables, or raw packed
        partials) — the loader's entry point into the engine."""
        plan = self.compile_gather(names, pipelines, packed=packed)
        parts, _ = self.execute(plan)
        return parts

    def fetch_objects_stream(self, names: Sequence[str],
                             pipelines: Sequence[Sequence[oc.ObjOp]],
                             packed: bool = False):
        """Streaming twin of ``fetch_objects``: yields ``(index,
        result)`` pairs the moment their per-OSD frame lands and
        decodes, in arrival order — the loader's windowed consume.  A
        consumer holding results for early indices finishes before the
        slowest OSD responds; results are bit-identical to the buffered
        gather."""
        store = self.vol.store
        plan = self.compile_gather(names, pipelines, packed=packed)
        pipes = [list(p) for p in plan.pipelines]
        if plan.exec_cls == EXEC_TABLE_GATHER:
            yield from store.exec_batch_iter(list(plan.names), pipes)
            return
        for frame in store.exec_concat_iter(list(plan.names), pipes):
            yield from _iter_frame(frame)

    # ------------------------------------------------------------ internals
    def _direct(self, mode, names, pipelines, predicates, shards=()):
        del shards  # the store regroups by primary OSD itself
        store = self.vol.store
        if mode == "combine":
            pruned: list[str] = []
            return store.exec_combine_iter(
                names, pipelines, prune=predicates,
                pruned_out=pruned), pruned
        if mode == "concat":
            pruned = []
            return store.exec_concat_iter(
                names, pipelines, prune=predicates,
                pruned_out=pruned), pruned
        return store.exec_batch(names, pipelines)

    def _client_eval(self, names, ops):
        """The no-pushdown baseline: whole objects to the client, the
        pipeline evaluated locally (byte accounting shows what pushdown
        saves)."""
        store = self.vol.store
        result: Any = concat_tables(
            [fmt.decode_block(store.get(n)) for n in names])
        for o in ops:
            impl = oc.get_impl(o.name)
            if o.name == "median":
                result = float(np.median(
                    np.asarray(result[o.params["col"]]).ravel()))
            elif not impl.table_out:
                result = impl.combine([impl.local(result, **o.params)],
                                      **o.params)
            else:
                result = impl.local(result, **o.params)
        return result


def _split_frames(n: int, frames) -> list:
    """Re-slice per-OSD concatenated frames into per-object tables,
    placed at their input positions (global row order restored)."""
    parts: list[dict | None] = [None] * n
    for frame in frames:
        _place_frame(parts, frame)
    return parts


def _iter_frame(frame: tuple):
    """Decode one per-OSD concatenated frame and yield its per-object
    ``(input_index, table)`` slices — the ONE place the frame layout
    (row_counts offsets into the concatenated block) is interpreted."""
    idxs, blob, counts = frame
    tab = fmt.decode_block(blob)
    off = 0
    for i, c in zip(idxs, counts):
        yield i, {k: v[off:off + c] for k, v in tab.items()}
        off += c


def _place_frame(parts: list, frame: tuple) -> None:
    """Slot one frame's per-object tables at their input positions
    (global row order restored) — the incremental half of the
    streaming consume."""
    for i, part in _iter_frame(frame):
        parts[i] = part


def _assemble_array(plan: PhysicalPlan, parts: list) -> np.ndarray:
    """Rebuild the dense N-d result of a hyperslab plan from the
    per-object ``{"cells", "chunk"}`` tables the OSDs served.

    Each object's cells arrive as C-order runs tagged with their global
    chunk id; the client re-derives every run's placement from
    (selection ∩ chunk slab) — the same arithmetic the OSD used to cut
    the run — so no per-cell coordinates ever cross the wire.  Chunks
    that are absent (pruned OSD-side by the predicate, or skipped
    whole-object) stay at the plan's fill value."""
    meta = plan.array_meta
    sp = Dataspace.from_json(meta["space"])
    hs = Hyperslab.from_json(meta["sel"])
    out = np.full(hs.out_shape(), meta.get("fill", 0),
                  dtype=np.dtype(sp.dtype))
    for part in parts:
        if part is None:
            continue
        cells = np.asarray(part["cells"])
        cids = np.asarray(part["chunk"])
        if cells.size == 0:
            continue
        # cells of one chunk are contiguous: split on chunk-id change
        run_starts = np.flatnonzero(np.diff(cids)) + 1
        bounds = [0, *run_starts.tolist(), len(cids)]
        for s, e in zip(bounds[:-1], bounds[1:]):
            hit = hs.intersect_slab(sp.chunk_slab(int(cids[s])))
            if hit is None:
                raise ValueError(
                    f"{plan.dataset}: served chunk {int(cids[s])} is "
                    "disjoint from the selection")
            _locs, offs, counts = hit
            out[tuple(slice(o, o + n)
                      for o, n in zip(offs, counts))] = \
                cells[s:e].reshape(counts)
    if meta.get("squeeze"):
        out = np.squeeze(out, axis=tuple(meta["squeeze"]))
    return out


def _result_rows(ops, result) -> int:
    if ops and not oc.get_impl(ops[-1].name).table_out:
        return 1  # scalar / one aggregate row
    return oc.table_n_rows(result) if isinstance(result, dict) else 1
