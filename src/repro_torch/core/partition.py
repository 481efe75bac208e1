"""Dataset -> object partitioning (paper §3.1 and §5 'future work' item 1).

Maps logical units to objects of *proper sizes*:

  * grouping: contiguous small units are packed into one object until the
    target object size is reached (amortizes per-object metadata);
  * splitting: units larger than ``max_object_bytes`` are split into
    row sub-ranges across several objects (bounded object size);
  * co-location: grouping is contiguous in row order, so rows that are
    accessed together (same logical neighborhood) land in the same object
    — and an optional ``colocate_rows`` quantum forbids groups from
    crossing that boundary (e.g. training-batch stripes);
  * minimum metadata: the resulting ObjectMap stores only the row
    boundaries and object names — O(n_objects), independent of n_rows.

The ObjectMap is itself serializable and is stored in the object store as
``<dataset>/.objmap`` so any client can bootstrap from the store alone.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Iterator

from repro_torch.core.logical import Dataspace, Hyperslab, LogicalDataset, RowRange


@dataclasses.dataclass(frozen=True)
class PartitionPolicy:
    target_object_bytes: int = 8 << 20     # Ceph-typical 4-32 MiB sweet spot
    max_object_bytes: int = 64 << 20       # RADOS-style hard cap
    colocate_rows: int = 0                 # group boundary quantum (0 = none)

    def __post_init__(self):
        if self.target_object_bytes <= 0:
            raise ValueError("target_object_bytes must be positive")
        if self.max_object_bytes < self.target_object_bytes:
            raise ValueError("max < target object bytes")


@dataclasses.dataclass(frozen=True)
class ObjectExtent:
    """One object's slice of the dataset: rows [row_start, row_stop)."""

    name: str
    row_start: int
    row_stop: int

    @property
    def rows(self) -> RowRange:
        return RowRange(self.row_start, self.row_stop)

    def __len__(self) -> int:
        return self.row_stop - self.row_start


@dataclasses.dataclass(frozen=True)
class ObjectMap:
    """Row-boundary index: object i covers [starts[i], starts[i+1]).

    ``version`` is the store version of the ``<dataset>/.objmap`` object
    this map was read from (-1 = not yet persisted / unknown).  Compiled
    plans stamp it so execute-time can detect that the map moved under
    them (re-partition) and re-derive their target objects; it is
    provenance, not content — excluded from equality and serialization.
    """

    dataset: LogicalDataset
    extents: tuple[ObjectExtent, ...]
    version: int = dataclasses.field(default=-1, compare=False)

    def __post_init__(self):
        prev = 0
        for e in self.extents:
            if e.row_start != prev:
                raise ValueError(f"gap/overlap at row {prev} ({e})")
            prev = e.row_stop
        if self.extents and prev != self.dataset.n_rows:
            raise ValueError(f"coverage ends at {prev} != "
                             f"{self.dataset.n_rows}")

    # ------------------------------------------------------------ lookup
    @property
    def n_objects(self) -> int:
        return len(self.extents)

    def lookup(self, rows: RowRange) -> list[tuple[ObjectExtent, RowRange]]:
        """Objects intersecting ``rows`` + the intersection *local* to the
        object (row 0 = object's first row)."""
        rows = RowRange(max(0, rows.start),
                        min(rows.stop, self.dataset.n_rows))
        if len(rows) == 0:
            return []
        starts = [e.row_start for e in self.extents]
        i = bisect.bisect_right(starts, rows.start) - 1
        out = []
        while i < len(self.extents) and self.extents[i].row_start < rows.stop:
            e = self.extents[i]
            inter = e.rows.intersect(rows)
            if inter is not None:
                out.append((e, inter.shift(-e.row_start)))
            i += 1
        return out

    def object_names(self) -> list[str]:
        return [e.name for e in self.extents]

    def __iter__(self) -> Iterator[ObjectExtent]:
        return iter(self.extents)

    # ------------------------------------------------------------ (de)ser
    def to_json(self) -> dict:
        return {"dataset": self.dataset.to_json(),
                "extents": [[e.name, e.row_start, e.row_stop]
                            for e in self.extents]}

    @staticmethod
    def from_json(d: dict) -> "ObjectMap":
        return ObjectMap(
            LogicalDataset.from_json(d["dataset"]),
            tuple(ObjectExtent(n, a, b) for n, a, b in d["extents"]))

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "ObjectMap":
        return ObjectMap.from_json(json.loads(b.decode()))


@dataclasses.dataclass(frozen=True)
class ArrayExtent:
    """One object's slice of a chunked array: chunk ids
    [chunk_start, chunk_stop) in row-major grid order."""

    name: str
    chunk_start: int
    chunk_stop: int

    def __len__(self) -> int:
        return self.chunk_stop - self.chunk_start


@dataclasses.dataclass(frozen=True)
class ArrayObjectMap:
    """Chunk-boundary index for an N-d Dataspace: object i covers chunk
    ids [extents[i].chunk_start, extents[i].chunk_stop).  Same provenance
    contract as ObjectMap: ``version`` is the store version of the
    ``.objmap`` object this was read from, excluded from equality."""

    space: Dataspace
    extents: tuple[ArrayExtent, ...]
    version: int = dataclasses.field(default=-1, compare=False)

    def __post_init__(self):
        prev = 0
        for e in self.extents:
            if e.chunk_start != prev:
                raise ValueError(f"gap/overlap at chunk {prev} ({e})")
            prev = e.chunk_stop
        if self.extents and prev != self.space.n_chunks:
            raise ValueError(f"coverage ends at chunk {prev} != "
                             f"{self.space.n_chunks}")

    @property
    def n_objects(self) -> int:
        return len(self.extents)

    def lookup_chunks(self, cids: list[int]) -> list[tuple[ArrayExtent,
                                                           list[int]]]:
        """Objects holding any of the (sorted) chunk ids, with the ids
        each object holds."""
        out: list[tuple[ArrayExtent, list[int]]] = []
        starts = [e.chunk_start for e in self.extents]
        for cid in cids:
            i = bisect.bisect_right(starts, cid) - 1
            if not 0 <= i < len(self.extents):
                continue
            e = self.extents[i]
            if not e.chunk_start <= cid < e.chunk_stop:
                continue
            if out and out[-1][0] is e:
                out[-1][1].append(cid)
            else:
                out.append((e, [cid]))
        return out

    def lookup(self, hs: Hyperslab) -> list[tuple[ArrayExtent, list[int]]]:
        return self.lookup_chunks(self.space.chunk_ids_overlapping(hs))

    def object_names(self) -> list[str]:
        return [e.name for e in self.extents]

    def __iter__(self) -> Iterator[ArrayExtent]:
        return iter(self.extents)

    # ------------------------------------------------------------ (de)ser
    def to_json(self) -> dict:
        return {"kind": "array", "space": self.space.to_json(),
                "extents": [[e.name, e.chunk_start, e.chunk_stop]
                            for e in self.extents]}

    @staticmethod
    def from_json(d: dict) -> "ArrayObjectMap":
        return ArrayObjectMap(
            Dataspace.from_json(d["space"]),
            tuple(ArrayExtent(n, a, b) for n, a, b in d["extents"]))

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "ArrayObjectMap":
        return ArrayObjectMap.from_json(json.loads(b.decode()))


def load_objmap(b: bytes) -> "ObjectMap | ArrayObjectMap":
    """Deserialize a ``.objmap`` blob of either kind.  Table maps have no
    "kind" field (back-compat with every already-stored map)."""
    d = json.loads(b.decode())
    if d.get("kind") == "array":
        return ArrayObjectMap.from_json(d)
    return ObjectMap.from_json(d)


def objmap_key(dataset_name: str) -> str:
    return f"{dataset_name}/.objmap"


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------


def plan_partition(ds: LogicalDataset,
                   policy: PartitionPolicy = PartitionPolicy()) -> ObjectMap:
    """Group/split logical units into object extents under the policy."""
    rb = ds.row_nbytes
    if rb <= 0:
        raise ValueError("zero-byte rows")
    target_rows = max(1, policy.target_object_bytes // rb)
    max_rows = max(1, policy.max_object_bytes // rb)

    extents: list[ObjectExtent] = []

    def emit(start: int, stop: int) -> None:
        extents.append(ObjectExtent(
            f"{ds.name}/obj.{len(extents):06d}", start, stop))

    row = 0
    acc_start = row
    for uid in range(ds.n_units):
        ur = ds.unit_range(uid)
        # unit bigger than max object: flush accumulator, split the unit
        if len(ur) > max_rows:
            if ur.start > acc_start:
                emit(acc_start, ur.start)
            s = ur.start
            while s < ur.stop:
                e = min(s + max_rows, ur.stop)
                emit(s, e)
                s = e
            acc_start = ur.stop
            continue
        # group boundary (co-location quantum): never straddle it
        if policy.colocate_rows:
            q = policy.colocate_rows
            if (ur.stop - 1) // q != acc_start // q and ur.start > acc_start:
                emit(acc_start, ur.start)
                acc_start = ur.start
        # grouping: flush when adding this unit would exceed target
        if (ur.stop - acc_start) * rb > policy.target_object_bytes \
                and ur.start > acc_start:
            emit(acc_start, ur.start)
            acc_start = ur.start
    if acc_start < ds.n_rows:
        emit(acc_start, ds.n_rows)
    if not extents and ds.n_rows == 0:
        emit(0, 0)
    return ObjectMap(ds, tuple(extents))


def compact_plan(omap: ObjectMap, sizes: dict[str, int],
                 policy: PartitionPolicy = PartitionPolicy()
                 ) -> list[tuple[int, int]]:
    """Runs of consecutive under-target extents worth folding into one
    object — ``[(start, stop), ...]`` extent-index ranges, each >= 2
    members.  ``sizes`` maps object name -> stored bytes; an absent or
    zero size breaks the run (the object is mid-write or gone — never
    compact it).  Greedy left-to-right: a run accumulates small
    neighbors until it reaches ``target_object_bytes`` (good enough —
    stop growing) and never exceeds ``max_object_bytes``.  This is the
    read side of the one-blob-per-append pattern: N tiny ``ckpt``/
    kvcache appends become ceil(total/target) proper objects."""
    runs: list[tuple[int, int]] = []
    n = len(omap.extents)

    def small(k: int) -> bool:
        s = sizes.get(omap.extents[k].name)
        return s is not None and 0 < s < policy.target_object_bytes

    i = 0
    while i < n:
        if not small(i):
            i += 1
            continue
        j, acc = i, 0
        while j < n and small(j):
            s = sizes[omap.extents[j].name]
            if acc and acc + s > policy.max_object_bytes:
                break
            acc += s
            j += 1
            if acc >= policy.target_object_bytes:
                break
        if j - i >= 2:
            runs.append((i, j))
        i = max(j, i + 1)
    return runs


def merge_run(omap: ObjectMap, start: int, stop: int,
              name: str) -> ObjectMap:
    """The map rewrite for one compacted run: extents [start, stop)
    collapse into a single extent ``name`` covering their combined row
    range.  Contiguity is preserved by construction (the run was
    consecutive), so the returned map revalidates; ``version`` carries
    over as provenance until the rewritten map is persisted (which
    stamps the real store version)."""
    if not (0 <= start < stop <= len(omap.extents)) or stop - start < 2:
        raise ValueError(f"bad merge run [{start}, {stop}) over "
                         f"{len(omap.extents)} extents")
    run = omap.extents[start:stop]
    merged = ObjectExtent(name, run[0].row_start, run[-1].row_stop)
    return ObjectMap(
        omap.dataset,
        omap.extents[:start] + (merged,) + omap.extents[stop:],
        version=omap.version)


def plan_array_partition(
        space: Dataspace,
        policy: PartitionPolicy = PartitionPolicy()) -> ArrayObjectMap:
    """Group row-major-consecutive chunks into objects of proper sizes —
    the array twin of ``plan_partition`` with the chunk as the logical
    unit.  A chunk is never split (it is the access/pruning granule), so
    one oversized chunk makes a one-chunk object."""
    cb = space.chunk_nbytes
    per_obj = max(1, min(policy.target_object_bytes // cb,
                         policy.max_object_bytes // cb) or 1)
    extents: list[ArrayExtent] = []
    c = 0
    while c < space.n_chunks:
        stop = min(c + per_obj, space.n_chunks)
        extents.append(ArrayExtent(
            f"{space.name}/obj.{len(extents):06d}", c, stop))
        c = stop
    return ArrayObjectMap(space, tuple(extents))
