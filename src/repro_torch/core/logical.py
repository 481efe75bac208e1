"""Logical datasets — the access-library-facing data model (paper §2 Fig 1).

This is the "application facing" half of an access library: named, typed,
table/array datasets addressed by a row coordinate system, independent of
any storage-system assumption.  The unit of storage mapping is the
*logical unit* (HDF5 chunk / ROOT basket / Parquet row group): a
contiguous slab of rows.  ``core.partition`` maps logical units to
objects; nothing in this module knows about objects or OSDs — that is the
point of the paper's split.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Column:
    """A named, typed column.  ``shape`` is the per-row trailing shape —
    e.g. a token-sequence table has Column("tokens", "int32", (4096,))."""

    name: str
    dtype: str
    shape: tuple[int, ...] = ()

    @property
    def row_nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape, dtype=np.int64)) if self.shape else np.dtype(self.dtype).itemsize)

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape)}

    @staticmethod
    def from_json(d: dict) -> "Column":
        return Column(d["name"], d["dtype"], tuple(d["shape"]))


@dataclasses.dataclass(frozen=True)
class RowRange:
    """Half-open row interval [start, stop)."""

    start: int
    stop: int

    def __post_init__(self):
        if self.start < 0 or self.stop < self.start:
            raise ValueError(f"bad RowRange [{self.start}, {self.stop})")

    def __len__(self) -> int:
        return self.stop - self.start

    def intersect(self, other: "RowRange") -> "RowRange | None":
        s, e = max(self.start, other.start), min(self.stop, other.stop)
        return RowRange(s, e) if s < e else None

    def shift(self, delta: int) -> "RowRange":
        return RowRange(self.start + delta, self.stop + delta)


@dataclasses.dataclass(frozen=True)
class LogicalDataset:
    """A table of ``n_rows`` rows split into logical units of
    ``unit_rows`` rows (last unit may be short)."""

    name: str
    columns: tuple[Column, ...]
    n_rows: int
    unit_rows: int

    def __post_init__(self):
        if self.unit_rows <= 0:
            raise ValueError("unit_rows must be positive")
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")

    # ------------------------------------------------------------ columns
    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name}: no column {name!r}")

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def row_nbytes(self) -> int:
        return sum(c.row_nbytes for c in self.columns)

    # ------------------------------------------------------------ units
    @property
    def n_units(self) -> int:
        return max(1, -(-self.n_rows // self.unit_rows))

    def unit_range(self, unit_id: int) -> RowRange:
        if not 0 <= unit_id < self.n_units:
            raise IndexError(unit_id)
        start = unit_id * self.unit_rows
        return RowRange(start, min(start + self.unit_rows, self.n_rows))

    def unit_nbytes(self, unit_id: int) -> int:
        return len(self.unit_range(unit_id)) * self.row_nbytes

    def units_overlapping(self, rows: RowRange) -> range:
        """Unit ids whose ranges intersect ``rows``."""
        rows = RowRange(max(rows.start, 0), min(rows.stop, self.n_rows))
        if len(rows) == 0:
            return range(0)
        return range(rows.start // self.unit_rows,
                     (rows.stop - 1) // self.unit_rows + 1)

    # ------------------------------------------------------------ (de)ser
    def to_json(self) -> dict:
        return {"name": self.name,
                "columns": [c.to_json() for c in self.columns],
                "n_rows": self.n_rows, "unit_rows": self.unit_rows}

    @staticmethod
    def from_json(d: dict) -> "LogicalDataset":
        return LogicalDataset(
            d["name"], tuple(Column.from_json(c) for c in d["columns"]),
            d["n_rows"], d["unit_rows"])


# --------------------------------------------------------------------------
# N-dimensional dataspaces (paper §2: "coordinate systems and associated
# slicing operations" — the HDF5/ROOT abstraction the token table lacks)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dataspace:
    """An N-d array dataset: ``shape`` cells of ``dtype`` split into a
    regular grid of ``chunk``-shaped chunks (HDF5 chunked layout).  The
    chunk is the logical unit of storage mapping — ``core.partition``
    groups consecutive chunk ids (row-major over the grid) into objects
    the way it groups row units for tables.  Edge chunks are logically
    clipped to ``shape``; physically every stored chunk is padded to
    the full chunk shape so all chunks of an object stack into one
    ``(k, *chunk)`` block (selections never reach the pad — they are
    clipped against ``shape``)."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    chunk: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "chunk", tuple(int(c) for c in self.chunk))
        if not self.shape:
            raise ValueError("Dataspace needs at least one axis")
        if len(self.chunk) != len(self.shape):
            raise ValueError(f"chunk rank {len(self.chunk)} != "
                             f"shape rank {len(self.shape)}")
        if any(d <= 0 for d in self.shape):
            raise ValueError(f"non-positive dims in shape {self.shape}")
        if any(c <= 0 for c in self.chunk):
            raise ValueError(f"non-positive dims in chunk {self.chunk}")

    # ------------------------------------------------------------ grid
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def grid(self) -> tuple[int, ...]:
        """Chunks per axis (edge chunks clipped)."""
        return tuple(-(-d // c) for d, c in zip(self.shape, self.chunk))

    @property
    def n_chunks(self) -> int:
        return int(np.prod(self.grid, dtype=np.int64))

    @property
    def chunk_nbytes(self) -> int:
        """Stored (padded) bytes of one chunk."""
        return int(np.dtype(self.dtype).itemsize
                   * np.prod(self.chunk, dtype=np.int64))

    def chunk_coords(self, cid: int) -> tuple[int, ...]:
        """Row-major chunk id -> grid coordinates."""
        if not 0 <= cid < self.n_chunks:
            raise IndexError(cid)
        out = []
        for g in reversed(self.grid):
            out.append(cid % g)
            cid //= g
        return tuple(reversed(out))

    def chunk_id(self, coords) -> int:
        cid = 0
        for x, g in zip(coords, self.grid):
            if not 0 <= x < g:
                raise IndexError(tuple(coords))
            cid = cid * g + int(x)
        return cid

    def chunk_slab(self, cid: int) -> tuple[tuple[int, int], ...]:
        """The half-open cell slab of one chunk, clipped to ``shape``."""
        return tuple(
            (x * c, min((x + 1) * c, d))
            for x, c, d in zip(self.chunk_coords(cid), self.chunk,
                               self.shape))

    def chunk_ids_overlapping(self, hs: "Hyperslab") -> list[int]:
        """Sorted chunk ids holding at least one selected cell.  Exact
        per axis (a stride longer than the chunk skips whole chunks),
        so object targeting and OSD-side resolution agree."""
        per_axis: list[list[int]] = []
        for s, e, t, c, g in zip(hs.starts, hs.stops, hs.steps,
                                 self.chunk, self.grid):
            ks = []
            for k in range(min(s // c, g - 1) if e > s else 0, g):
                c0, c1 = k * c, (k + 1) * c
                if c0 >= e:
                    break
                if _axis_intersect(s, e, t, c0, c1) is not None:
                    ks.append(k)
            per_axis.append(ks)
        if any(not ks for ks in per_axis):
            return []
        out: list[int] = []

        def walk(axis: int, prefix: list[int]) -> None:
            if axis == self.ndim:
                out.append(self.chunk_id(prefix))
                return
            for k in per_axis[axis]:
                walk(axis + 1, prefix + [k])

        walk(0, [])
        out.sort()
        return out

    # ------------------------------------------------------------ (de)ser
    def to_json(self) -> dict:
        return {"name": self.name, "shape": list(self.shape),
                "dtype": self.dtype, "chunk": list(self.chunk)}

    @staticmethod
    def from_json(d: dict) -> "Dataspace":
        return Dataspace(d["name"], tuple(d["shape"]), d["dtype"],
                         tuple(d["chunk"]))


def _axis_intersect(s: int, e: int, t: int, c0: int,
                    c1: int) -> tuple[int, int, int] | None:
    """One axis of a hyperslab∩chunk intersection: the selected indices
    ``{s + k*t} ∩ [c0, c1)`` as ``(first, stop, n)`` in GLOBAL cell
    coordinates, or None when empty.  ``(first - s) // t`` is the output
    offset — strided selections land dense in output space."""
    lo, hi = max(s, c0), min(e, c1)
    if lo >= hi:
        return None
    first = s + -(-(lo - s) // t) * t
    if first >= hi:
        return None
    n = -(-(hi - first) // t)
    return first, hi, n


@dataclasses.dataclass(frozen=True)
class Hyperslab:
    """An h5py-style N-d selection: ``start/stop/step`` per axis
    (``dset[10:200:2, :, 3]``), already normalized against a shape —
    every axis has explicit non-negative bounds and a positive step.
    ``squeeze`` lists the axes selected by a scalar index (dropped from
    the client-side result, exactly like numpy basic indexing); the
    wire form carries only the per-axis bounds, squeezing is client
    assembly."""

    starts: tuple[int, ...]
    stops: tuple[int, ...]
    steps: tuple[int, ...]
    squeeze: tuple[int, ...] = ()

    def __post_init__(self):
        for tup in (self.starts, self.stops, self.steps):
            if len(tup) != len(self.starts):
                raise ValueError("axis count mismatch")
        if any(t <= 0 for t in self.steps):
            raise ValueError(f"steps must be positive: {self.steps}")
        if any(s < 0 or e < s for s, e in zip(self.starts, self.stops)):
            raise ValueError("bad selection bounds")

    @staticmethod
    def from_key(shape: Sequence[int], key) -> "Hyperslab":
        """Build a normalized selection from a numpy basic-indexing key:
        slices (with negatives / omitted bounds), scalar ints (squeeze
        axes), ``...`` filling to rank.  Negative steps are rejected —
        a storage-side selection serves monotone coordinates."""
        if not isinstance(key, tuple):
            key = (key,)
        if sum(1 for k in key if k is Ellipsis) > 1:
            raise IndexError("an index can only have one ellipsis")
        if Ellipsis in key:
            i = key.index(Ellipsis)
            fill = len(shape) - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1:]
        if len(key) > len(shape):
            raise IndexError(f"too many indices ({len(key)}) for shape "
                             f"{tuple(shape)}")
        key = key + (slice(None),) * (len(shape) - len(key))
        starts, stops, steps, squeeze = [], [], [], []
        for ax, (k, d) in enumerate(zip(key, shape)):
            if isinstance(k, slice):
                if k.step is not None and k.step < 0:
                    raise ValueError("negative steps are not supported "
                                     "in hyperslab selections")
                s, e, t = k.indices(d)
            else:
                i = int(k)
                if i < 0:
                    i += d
                if not 0 <= i < d:
                    raise IndexError(f"index {k} out of range for axis "
                                     f"{ax} with size {d}")
                s, e, t = i, i + 1, 1
                squeeze.append(ax)
            starts.append(s)
            stops.append(max(s, e))
            steps.append(t)
        return Hyperslab(tuple(starts), tuple(stops), tuple(steps),
                         tuple(squeeze))

    @property
    def ndim(self) -> int:
        return len(self.starts)

    def out_shape(self) -> tuple[int, ...]:
        """Dense output shape BEFORE squeeze (selected count per axis)."""
        return tuple(max(0, -(-(e - s) // t))
                     for s, e, t in zip(self.starts, self.stops,
                                        self.steps))

    def n_cells(self) -> int:
        return int(np.prod(self.out_shape(), dtype=np.int64))

    def intersect_slab(
            self, slab: Sequence[tuple[int, int]]
    ) -> tuple[tuple, tuple, tuple] | None:
        """Intersect this selection with a cell slab (a chunk): returns
        ``(locals, offs, counts)`` — per-axis ``(start, stop, step)``
        slices LOCAL to the slab origin, the per-axis offsets of the
        piece in dense output coordinates, and its per-axis counts —
        or None when no cell of the slab is selected.  The piece is
        always a dense block in output space: output index
        ``(i - start) // step`` maps the strided selection to
        consecutive cells."""
        locals_, offs, counts = [], [], []
        for (s, e, t), (c0, c1) in zip(
                zip(self.starts, self.stops, self.steps), slab):
            hit = _axis_intersect(s, e, t, c0, c1)
            if hit is None:
                return None
            first, stop, n = hit
            locals_.append((first - c0, stop - c0, t))
            offs.append((first - s) // t)
            counts.append(n)
        return tuple(locals_), tuple(offs), tuple(counts)

    # ------------------------------------------------------------ (de)ser
    def to_json(self) -> dict:
        return {"starts": list(self.starts), "stops": list(self.stops),
                "steps": list(self.steps),
                "squeeze": list(self.squeeze)}

    @staticmethod
    def from_json(d: dict) -> "Hyperslab":
        return Hyperslab(tuple(d["starts"]), tuple(d["stops"]),
                         tuple(d["steps"]),
                         tuple(d.get("squeeze", ())))


def validate_table(ds: LogicalDataset,
                   table: Mapping[str, np.ndarray],
                   rows: RowRange | None = None) -> None:
    """Check a concrete column dict against the dataset schema."""
    n = len(rows) if rows is not None else ds.n_rows
    for c in ds.columns:
        if c.name not in table:
            raise KeyError(f"missing column {c.name!r}")
        a = table[c.name]
        want = (n, *c.shape)
        if tuple(a.shape) != want:
            raise ValueError(f"{c.name}: shape {a.shape} != {want}")
        if a.dtype != np.dtype(c.dtype):
            raise TypeError(f"{c.name}: dtype {a.dtype} != {c.dtype}")


def concat_tables(parts: Sequence[Mapping[str, np.ndarray]]) -> dict:
    if not parts:
        return {}
    keys = parts[0].keys()
    return {k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0)
            for k in keys}
