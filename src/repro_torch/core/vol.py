"""The two-plugin VOL architecture (paper §4.1, Fig. 2).

``GlobalVOL`` is the client-side plugin: it intercepts dataset-level
calls (create/write/read/query), decomposes them into per-object
sub-requests using the ObjectMap, and hands every read-side request to
the ONE scan engine (``core.scan``): ``read`` compiles to a row-range
``PhysicalPlan``, ``query`` compiles a raw objclass pipeline, and
``scan`` exposes the fluent builder (``vol.scan("ds").filter(...)
.agg(...).execute()``).  The engine — not this module — decides the
prune strategy and execution class; the VOL contributes the global
metadata the engine compiles against (ObjectMap, zone-map cache,
column bounds for the approx-median rewrite).

Every interaction rides the store's symmetric per-OSD batch plane:
writes go through ``ObjectStore.put_batch`` (one request per primary
OSD — windowed/streaming when transfers take simulated time, so the
per-object encode overlaps the NIC stream); compiled plans execute
through the streaming consume of ``exec_combine`` (aggregate tails:
one partial per OSD), ``exec_concat`` (table-out tails: ONE framed
table response per OSD, decoded frame-by-frame as they land), or
``exec_batch`` (per-object results) — fabric ops AND result frames
scale with the number of OSDs, not the number of objects, on every
path, and wall clock scales with the slowest OSD, not the sum.

Pruning is pushed down by default: the filter expression TREE
(``core.expr`` — OR-groups, IN-lists, ranges, prefixes, negations)
rides serialized inside the batched objclass request and each OSD
skips objects its own CURRENT zone-map xattrs provably rule out (one
interval-arithmetic rule, shared with the client planner) — zero
client zone-map requests and no plan→execute TOCTOU window.  Row
ranges ship the same way: a ``row_slice`` op carries GLOBAL rows that
each OSD resolves against its objects' own extent xattrs.  The classic
client-side prune (``plan``) remains for the ``prune="client"``
strategy: it consults an
epoch-keyed zone-map cache (invalidated wholesale on cluster-epoch
bumps, per object on local rewrites, warmed in one metadata request
per OSD) and revalidates every prune-positive object against the
store's monotonic per-object ``version`` tag — narrowing cross-client
staleness to the plan→execute gap, which only the pushed-down prune
closes entirely.

``LocalVOL`` is the storage-side plugin: it decides the *physical*
representation of each object (layout row/col, per-column codec) from
local information, executes objclass pipelines, and adapts layout to the
observed workload ("physical design management", paper §5) — all without
the client or the access library knowing (independent evolution, goal 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import numpy as np

from repro_torch.core import format as fmt
from repro_torch.core import objclass as oc
from repro_torch.core.logical import (
    Dataspace, Hyperslab, LogicalDataset, RowRange, validate_table)
from repro_torch.core.partition import (
    ArrayObjectMap, ObjectMap, PartitionPolicy, load_objmap, objmap_key,
    plan_array_partition, plan_partition)
from repro_torch.core.scan import Scan, ScanEngine
from repro_torch.core.store import ObjectStore


# --------------------------------------------------------------------------
# LocalVOL — storage-side physical design
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LocalVOL:
    """Per-deployment physical design policy.

    ``codec_for`` picks a per-column codec from the column's value range —
    e.g. token ids bitpack to ceil(log2(vocab)) bits (2-3x over int32).
    ``access_stats`` counts column-scan vs row-fetch requests; when scans
    dominate, stored row-layout objects are transformed to columnar
    (online physical design transformation).
    """

    default_layout: str = "col"
    bitpack_ints: bool = True
    scan_to_row_threshold: float = 0.75
    access_stats: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"scan": 0, "fetch": 0})

    def codecs_for(self, table: Mapping[str, np.ndarray]) -> dict[str, str]:
        return fmt.auto_codecs(table, bitpack_ints=self.bitpack_ints)

    def encode(self, table: Mapping[str, np.ndarray]) -> bytes:
        layout = self.default_layout
        codecs = self.codecs_for(table) if layout == "col" else {}
        return fmt.encode_block(table, layout=layout, codecs=codecs)

    def note_access(self, kind: str) -> None:
        self.access_stats[kind] = self.access_stats.get(kind, 0) + 1

    def preferred_layout(self) -> str:
        s, f = self.access_stats["scan"], self.access_stats["fetch"]
        if s + f == 0:
            return self.default_layout
        return "col" if s / (s + f) >= (1 - self.scan_to_row_threshold) \
            else "row"


# --------------------------------------------------------------------------
# GlobalVOL — client-side decompose / scatter / gather
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """The decomposition of one logical request into object sub-requests."""

    sub_requests: tuple            # ((obj_name, local RowRange), ...)
    pruned: tuple                  # object names skipped via zone maps
    pushdown: bool                 # ops run storage-side?


class GlobalVOL:
    def __init__(self, store: ObjectStore, *,
                 local: LocalVOL | None = None, workers: int = 8):
        self.store = store
        self.local = local or LocalVOL()
        self.workers = workers
        # the ONE plan→compile→execute surface (core.scan); read/query/
        # scan and the Skyhook driver all route through it
        self.engine = ScanEngine(self)
        # client-side zone-map cache, keyed by cluster-map epoch:
        # name -> (zone_map, version-it-was-read-at).  Warmed in one
        # batched metadata request per OSD instead of one xattr lookup
        # per object; the version lets ``plan`` detect rewrites by
        # OTHER clients (cross-client coherence).
        self._zm_cache: dict[str, tuple[dict, int]] = {}
        self._zm_epoch: int = -1

    def _pin_epoch(self) -> None:
        """Invalidate the zone-map cache if the cluster map moved; pin
        it to the current epoch (the single invalidation rule, shared by
        the read side and by cache-on-write)."""
        epoch = self.store.cluster.epoch
        if epoch != self._zm_epoch:  # failure/resize: invalidate all
            self._zm_cache.clear()
            self._zm_epoch = epoch

    @staticmethod
    def _zm_entry(xattr: dict) -> tuple[dict, int]:
        return xattr.get("zone_map", {}), int(xattr.get("version", -1))

    def _warm_zone_maps(self, names: Iterable[str]) -> set[str]:
        """Fill cache misses with ONE batched metadata request per OSD
        (K requests for N objects, however cold the cache).  Returns
        the names fetched by THIS call — they are current as of now, so
        the caller can skip revalidating them."""
        self._pin_epoch()
        missing = [n for n in names if n not in self._zm_cache]
        if not missing:
            return set()
        infos = self.store.list_zone_maps(missing)
        for n in missing:
            self._zm_cache[n] = self._zm_entry(infos.get(n, {}))
        return set(missing)

    def _zone_map(self, name: str) -> dict:
        self._pin_epoch()
        ent = self._zm_cache.get(name)
        if ent is None:
            ent = self._zm_entry(self.store.xattr(name))
            self._zm_cache[name] = ent
        return ent[0]

    # ------------------------------------------------------------ create
    def create(self, ds: LogicalDataset,
               policy: PartitionPolicy = PartitionPolicy()) -> ObjectMap:
        """Plan the dataset->object mapping and persist it to the store."""
        omap = plan_partition(ds, policy)
        v = self.store.put(objmap_key(ds.name), omap.to_bytes())
        return dataclasses.replace(omap, version=v)

    def open(self, dataset_name: str) -> ObjectMap | ArrayObjectMap:
        """Bootstrap a dataset's object map from the store alone —
        table (``ObjectMap``) or N-d array (``ArrayObjectMap``), the
        serialized ``kind`` field picks.  The map carries the
        ``.objmap`` object's store version so compiled plans can later
        detect a re-partition (row-slice / hyperslab targeting refresh)
        without re-reading the map."""
        blob, v = self.store.get_with_version(objmap_key(dataset_name))
        return dataclasses.replace(load_objmap(blob), version=v)

    def reopen(self, omap: ObjectMap | ArrayObjectMap
               ) -> ObjectMap | ArrayObjectMap:
        """Cheap staleness check for a held map: probe the ``.objmap``
        object's CURRENT store version (one xattr round trip) and
        re-open only when it moved — e.g. after the maintenance plane's
        compactor rewrote the extents under a long-lived client.  A
        matching version returns the map unchanged."""
        name = omap.dataset.name if isinstance(omap, ObjectMap) \
            else omap.space.name
        v = int(self.store.xattr(objmap_key(name)).get("version", -1))
        if v == omap.version:
            return omap
        return self.open(name)

    # ------------------------------------------------------------ write
    def write(self, omap: ObjectMap, table: Mapping[str, np.ndarray],
              *, rows: RowRange | None = None, workers: int | None = None,
              forwarding: bool = True,
              window_bytes: int | None = None,
              window_objects: int | None = None) -> int:
        """Scatter a row range to its objects through the batched write
        plane: ONE request per primary OSD (with server-side chain
        replication and in-batch failover), so ingest pays K round
        trips for N objects.  Parallelism across OSD groups is the
        store's, gated on ``io_simulated()``; ``workers`` is kept for
        API compatibility and ignored.

        When transfers take simulated time the sub-writes STREAM: the
        per-object encode (slice + zone map + codec) runs lazily and
        ``put_batch``'s windowed mode flushes per-OSD sub-write groups
        as each window of encoded bytes is ready, overlapping encode
        with the NIC stream instead of buffering the whole batch
        (``Fabric.overlap_s`` / ``stream_windows`` measure it).  Pass
        ``window_bytes``/``window_objects`` to pick the window, or
        ``window_objects=0`` to force the buffered path; the default
        defers to ``ObjectStore.default_window_bytes()`` (buffered when
        no I/O is simulated — feeder threads only cost GIL there).
        Stored bytes, versions, and fabric-op counts are identical
        either way.

        ``forwarding=False`` bypasses the plugin machinery and writes one
        native blob — the paper's Table-1 native-HDF5 baseline.
        Returns bytes written (client->store).
        """
        del workers
        ds = omap.dataset
        rows = rows or RowRange(0, ds.n_rows)
        validate_table(ds, table, rows)
        if not forwarding:
            # native access-library path: the app serializes once and
            # writes its LOCAL store — no forwarding hop, no replication
            blob = self.local.encode(dict(table))
            name = f"{ds.name}/native"
            self.store.osds[self.store.cluster.primary(name)].put(name,
                                                                  blob)
            return len(blob)

        subs = omap.lookup(rows)
        # pin the cache to the current epoch so the zone maps we are
        # about to cache-on-write survive the first read-side lookup
        self._pin_epoch()

        if window_bytes is None and window_objects is None:
            window_bytes = self.store.default_window_bytes()
        names = [extent.name for extent, _ in subs]
        zms: list[dict] = []
        nbytes = [0]

        def encoded():
            """Lazy per-object encoder: yields (blob, xattr) pairs for
            ``put_batch`` to stream while the next part encodes."""
            for extent, local_rows in subs:
                glob = local_rows.shift(extent.row_start)
                part = {k: np.asarray(v)[glob.start - rows.start:
                                         glob.stop - rows.start]
                        for k, v in table.items()}
                zm = fmt.zone_map(part)
                zms.append(zm)
                blob = self.local.encode(part)
                nbytes[0] += len(blob)
                yield blob, {"zone_map": zm,
                             "rows": [glob.start, glob.stop]}

        if window_bytes or window_objects:
            versions = self.store.put_batch(
                names, encoded(), window_bytes=window_bytes,
                window_objects=window_objects)
        else:
            items = list(encoded())
            versions = self.store.put_batch(
                names, [b for b, _ in items], [x for _, x in items])
        for name, zm, v in zip(names, zms, versions):
            self._zm_cache[name] = (zm, v)  # keep the cache fresh
        return nbytes[0]

    # ------------------------------------------------------------ arrays
    def create_array(self, space: Dataspace,
                     policy: PartitionPolicy = PartitionPolicy()
                     ) -> ArrayObjectMap:
        """Plan the chunk->object mapping for an N-d dataspace and
        persist it to the store (the array twin of ``create``)."""
        amap = plan_array_partition(space, policy)
        v = self.store.put(objmap_key(space.name), amap.to_bytes())
        return dataclasses.replace(amap, version=v)

    def open_array(self, dataset_name: str) -> ArrayObjectMap:
        """``open`` for arrays; raises if the name maps a table."""
        amap = self.open(dataset_name)
        if not isinstance(amap, ArrayObjectMap):
            raise TypeError(f"{dataset_name!r} is a table dataset; "
                            "use open()")
        return amap

    def write_array(self, amap: ArrayObjectMap, arr: np.ndarray,
                    *, window_bytes: int | None = None,
                    window_objects: int | None = None) -> int:
        """Scatter a full N-d array to its objects through the batched
        write plane.  Each object stores its chunks PADDED to the full
        chunk shape and stacked as one ``(k, *chunk)`` block column, so
        the OSD-side ``hyperslab_local`` executor indexes chunks by
        position; selections never reach the pad because intersections
        are clipped to the logical shape.  Per-chunk zone maps (over
        UNPADDED values) ride in the ``chunk_zone_maps`` xattr — the
        granule OSD-side chunk pruning keys on — next to the
        ``chunks`` extent xattr that late-binds compiled hyperslab
        plans, and an object-level ``zone_map`` merged from them keeps
        whole-object pruning and the client zone-map cache working
        unchanged.  Streams through ``put_batch`` exactly like
        ``write``.  Returns bytes written."""
        sp = amap.space
        arr = np.asarray(arr, dtype=np.dtype(sp.dtype))
        if arr.shape != sp.shape:
            raise ValueError(f"array shape {arr.shape} != dataspace "
                             f"shape {sp.shape}")
        self._pin_epoch()
        if window_bytes is None and window_objects is None:
            window_bytes = self.store.default_window_bytes()
        names = [e.name for e in amap.extents]
        zms: list[dict] = []
        nbytes = [0]

        def encoded():
            for ext in amap.extents:
                stack, czms, unpadded = [], [], []
                for cid in range(ext.chunk_start, ext.chunk_stop):
                    slab = sp.chunk_slab(cid)
                    piece = arr[tuple(slice(a, b) for a, b in slab)]
                    pad = np.zeros(sp.chunk, dtype=arr.dtype)
                    pad[tuple(slice(0, s) for s in piece.shape)] = piece
                    stack.append(pad)
                    czms.append(fmt.zone_map({"data": piece.ravel()}))
                    unpadded.append(piece.ravel())
                zm = fmt.zone_map({"data": np.concatenate(unpadded)})
                zms.append(zm)
                blob = self.local.encode({"data": np.stack(stack)})
                nbytes[0] += len(blob)
                yield blob, {"zone_map": zm,
                             "chunks": [ext.chunk_start, ext.chunk_stop],
                             "chunk_zone_maps": czms}

        if window_bytes or window_objects:
            versions = self.store.put_batch(
                names, encoded(), window_bytes=window_bytes,
                window_objects=window_objects)
        else:
            items = list(encoded())
            versions = self.store.put_batch(
                names, [b for b, _ in items], [x for _, x in items])
        for name, zm, v in zip(names, zms, versions):
            self._zm_cache[name] = (zm, v)
        return nbytes[0]

    def read_array(self, amap: ArrayObjectMap, key,
                   *, where=None, fill=0,
                   prune: str = "auto") -> np.ndarray:
        """Gather one hyperslab selection (a numpy-style index key or a
        :class:`Hyperslab`) through the scan engine — the ``row_slice``
        contract lifted to N dimensions: the GLOBAL selection rides to
        each OSD, which resolves it against its own ``chunks`` xattr
        and prunes whole chunks via ``where`` + per-chunk zone maps."""
        hs = key if isinstance(key, Hyperslab) \
            else Hyperslab.from_key(amap.space.shape, key)
        plan = self.engine.compile_hyperslab(
            amap, hs, where=where, fill=fill, prune=prune)
        out, _ = self.engine.execute(plan, omap=amap)
        return out

    def array(self, dataset: str | ArrayObjectMap) -> "ArrayView":
        """Open an indexable view: ``vol.array("a")[2:10, ::3]``."""
        amap = self.open_array(dataset) if isinstance(dataset, str) \
            else dataset
        return ArrayView(self, amap)

    def repartition_array(self, amap: ArrayObjectMap,
                          policy: PartitionPolicy) -> ArrayObjectMap:
        """Re-pack the array's chunks into objects under a new policy
        and bump the ``.objmap`` version — compiled hyperslab plans
        keep serving correct cells through the late-binding ``chunks``
        xattr and recompile on the version bump (``_refresh``)."""
        sp = amap.space
        full = tuple(slice(0, s) for s in sp.shape)
        data = self.read_array(amap, full, prune="none")
        new = plan_array_partition(sp, policy)
        self.write_array(new, data)
        for name in set(amap.object_names()) - set(new.object_names()):
            self.store.delete(name)
        v = self.store.put(objmap_key(sp.name), new.to_bytes())
        return dataclasses.replace(new, version=v)

    # ------------------------------------------------------------ scan
    def scan(self, dataset: str | ObjectMap) -> Scan:
        """Open a fluent scan over a mapped dataset: compose filters /
        projection / aggregates, then ``.execute()`` (or ``.explain()``
        for the compiled :class:`~repro_torch.core.scan.PhysicalPlan`)."""
        name = dataset if isinstance(dataset, str) \
            else dataset.dataset.name
        return Scan(dataset=name).bind(self)

    # ------------------------------------------------------------ read
    def read(self, omap: ObjectMap, rows: RowRange,
             columns: list[str] | None = None) -> dict[str, np.ndarray]:
        """Gather a row range; per-object select+project run storage-side
        so only requested rows/columns move, and each OSD concatenates
        its result tables into ONE framed response (``exec_concat``)."""
        plan = self.engine.compile_read(omap, rows, columns)
        table, _ = self.engine.execute(plan, omap=omap)
        return table

    # ------------------------------------------------------------ query
    def plan(self, omap: ObjectMap, ops: list[oc.ObjOp],
             names: list[str] | None = None) -> ReadPlan:
        """CLIENT-SIDE prune planning (the ``prune="client"`` strategy;
        the default pushed-down prune needs no client plan at all —
        see ``core.scan``): prune objects whose cached zone maps cannot
        match the filter expression tree (the SAME
        ``objclass.zone_map_prunes`` interval rule the OSDs apply, so
        the two strategies agree bit-exactly on identical metadata).
        ``names`` restricts planning to
        a candidate subset (e.g. a row-ranged scan's objects) so the
        warm/revalidation never touches the rest of the dataset.

        Prune decisions are only as good as the cached zone map, so
        every prune-positive object is revalidated against its current
        xattr ``version`` (one batched metadata request per OSD).  A
        version mismatch means another client rewrote the object at
        this epoch — the fresh zone map replaces the cached one and the
        decision is re-made.  This bounds cross-client staleness to the
        plan→execute gap (a rewrite landing after revalidation is
        caught by the next plan).  Kept objects need no revalidation:
        scanning an object whose zone map went stale is safe, its data
        is read fresh from the OSD."""
        pushdown = oc.pipeline_decomposable(ops)
        names = list(names) if names is not None \
            else [e.name for e in omap]
        prunable = [o for o in ops if o.name == "filter"]
        if not prunable:
            return ReadPlan(tuple((n, None) for n in names), (),
                            pushdown)
        fresh = self._warm_zone_maps(names)  # K requests however cold
        preds = oc.filter_predicates(prunable)

        def prunes(name: str) -> bool:
            return oc.zone_map_prunes(self._zm_cache[name][0], preds)

        keep, pruned = [], []
        for name in names:
            (pruned if prunes(name) else keep).append(name)
        if pruned:  # revalidate prune-positive objects (coherence);
            # entries the warm above just fetched are already current —
            # re-fetching them would double the cold-cache metadata cost
            to_check = [n for n in pruned if n not in fresh]
            if to_check:
                current = self.store.list_zone_maps(to_check)
                for name in to_check:
                    ent = self._zm_entry(current.get(name, {}))
                    if ent[1] != self._zm_cache[name][1]:
                        self._zm_cache[name] = ent  # stale: re-decide
            still = {name for name in pruned if prunes(name)}
            # rebuild in omap (row) order: a revalidated un-prune must
            # not reorder the gather for table-out pipelines
            keep = [n for n in names if n not in still]
            pruned = [n for n in names if n in still]
        return ReadPlan(tuple((k, None) for k in keep), tuple(pruned),
                        pushdown)

    def query(self, omap: ObjectMap, ops: list[oc.ObjOp],
              *, allow_approx: bool = False,
              prune: str = "auto") -> tuple[Any, dict]:
        """Execute an op pipeline over the whole dataset through the
        scan engine: mergeable aggregate tails combine per OSD, table
        tails concatenate per OSD, holistic tails (median) gather their
        projected input — unless ``allow_approx`` rewrites them to the
        decomposable sketch (paper §3.2).  ``prune`` picks the strategy
        ("auto"/"pushdown": predicates ride to the OSDs; "client": the
        cached-zone-map planner; "none").  Returns (result, stats).
        """
        before = self.store.fabric.snapshot()
        plan = self.engine.compile_ops(
            omap, ops, allow_approx=allow_approx, prune=prune)
        return self.engine.execute(plan, before=before, omap=omap)

    # ------------------------------------------------------------ helpers
    def _column_bounds(self, omap: ObjectMap,
                       col: str) -> tuple[float, float]:
        self._warm_zone_maps([e.name for e in omap])
        lo, hi = np.inf, -np.inf
        for extent in omap:
            zm = self._zone_map(extent.name)
            if col in zm:
                lo, hi = min(lo, zm[col][0]), max(hi, zm[col][1])
        if not np.isfinite(lo):
            lo, hi = 0.0, 1.0
        return float(lo), float(hi) + 1e-9


# --------------------------------------------------------------------------
# ArrayView — numpy-style front end over a mapped dataspace
# --------------------------------------------------------------------------


class ArrayView:
    """Indexable handle over one mapped N-d dataspace: ``view[key]``
    compiles the key to a hyperslab plan and executes it (storage-side
    selection + chunk pruning), returning a dense ndarray shaped like
    ``np.asarray(full)[key]`` would be.  ``sel`` adds the pushed-down
    ``where`` predicate (cells whose chunk is pruned come back as
    ``fill``) — the array analogue of ``Scan.filter``."""

    def __init__(self, vol: GlobalVOL, amap: ArrayObjectMap):
        self.vol = vol
        self.amap = amap

    @property
    def space(self) -> Dataspace:
        return self.amap.space

    @property
    def shape(self) -> tuple[int, ...]:
        return self.amap.space.shape

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.amap.space.dtype)

    def __getitem__(self, key) -> np.ndarray:
        return self.vol.read_array(self.amap, key)

    def sel(self, key, *, where=None, fill=0,
            prune: str = "auto") -> np.ndarray:
        return self.vol.read_array(self.amap, key, where=where,
                                   fill=fill, prune=prune)

    def refresh(self) -> "ArrayView":
        """Re-open the map (picks up a re-partition)."""
        self.amap = self.vol.open_array(self.amap.space.name)
        return self
