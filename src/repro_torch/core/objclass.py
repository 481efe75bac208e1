"""Storage-side operation registry — Ceph object classes / SkyhookDM
extensions (paper §2 goal 2, §4.2).

An ``ObjOp`` is a named operation executed *inside* an OSD against one
object's block.  A pipeline ``[select, filter, project, agg]`` runs
server-side and only the (usually much smaller) result crosses the wire.

Composability (paper §3.2) is explicit: every op declares whether it is
*decomposable* — i.e. per-object partials exist with an associative
``combine`` — or *holistic* (median & friends), which forces a gather of
its input to the client unless an approximate decomposable form is
accepted (we provide a P² quantile estimator as that approximation).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.core import expr as ex
from repro_torch.core import format as fmt
from repro_torch.core.logical import Dataspace, Hyperslab


@dataclasses.dataclass(frozen=True)
class ObjOp:
    """One pipeline stage: ``op(name, **params)``."""

    name: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"name": self.name, "params": dict(self.params)}

    @staticmethod
    def from_json(d: dict) -> "ObjOp":
        return ObjOp(d["name"], d.get("params", {}))


def op(name: str, **params: Any) -> ObjOp:
    return ObjOp(name, params)


@dataclasses.dataclass(frozen=True)
class OpImpl:
    local: Callable[..., Any]              # table -> table | partial
    combine: Callable[[list], Any] | None  # partials -> result (if decomp.)
    decomposable: bool
    table_in: bool = True                  # consumes a table (vs a partial)
    table_out: bool = True                 # emits a table (vs a partial)
    # associative partials -> ONE partial (same shape as ``local``'s
    # output).  Unlike ``combine`` (partials -> final result) a merge can
    # run *on the OSD*, folding its local partials into a single partial
    # per batched request — the server-side half of a two-level combine.
    merge: Callable[[list], Any] | None = None


_REGISTRY: dict[str, OpImpl] = {}


def register(name: str, impl: OpImpl) -> None:
    if name in _REGISTRY:
        raise KeyError(f"op {name!r} already registered")
    _REGISTRY[name] = impl


def get_impl(name: str) -> OpImpl:
    if name not in _REGISTRY:
        raise KeyError(f"unknown objclass op {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_ops() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# built-in ops (tables are dict[str, np.ndarray])
# --------------------------------------------------------------------------


def _select(table, rows: tuple[int, int]):
    s, e = rows
    return {k: v[s:e] for k, v in table.items()}


def _project(table, cols: list[str]):
    missing = [c for c in cols if c not in table]
    if missing:
        raise KeyError(f"project: missing {missing}")
    return {c: table[c] for c in cols}


def _filter_expr(params: Mapping) -> ex.Expr:
    """The expression of one ``filter`` op: a predicate tree in
    ``expr`` (wire dict or Expr), or the legacy flat
    ``(col, cmp, value)`` params — normalized to ONE representation so
    every layer walks the same tree."""
    e = params.get("expr")
    if e is not None:
        return ex.ensure(e)
    return ex.Cmp(params["col"], params["cmp"], params["value"])


def _filter(table, **params):
    """Tree-walking filter: one vectorized numpy mask per leaf, mask
    combinators per node (``expr.Expr.mask``)."""
    flat = _filter_expr(params).mask(table)
    return {k: v[flat] for k, v in table.items()}


# ---- decomposable aggregates: partial = dict of ndarrays ----


def _agg_local(table, col: str, fn: str):
    a = np.asarray(table[col], dtype=np.float64).ravel()
    if fn == "count":
        return {"count": np.float64(a.size)}
    if a.size == 0:  # identity partials
        if fn == "mean":
            return {"sum": np.float64(0.0), "count": np.float64(0)}
        ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}
        return {fn: np.float64(ident[fn])}
    if fn == "sum":
        return {"sum": a.sum()}
    if fn == "min":
        return {"min": a.min()}
    if fn == "max":
        return {"max": a.max()}
    if fn == "mean":
        return {"sum": a.sum(), "count": np.float64(a.size)}
    raise ValueError(fn)


def _agg_merge(partials: list, fn: str, **_):
    """Fold agg partials into ONE partial of the same shape (associative,
    so OSD-merged partials re-merge/combine exactly like raw ones)."""
    keys = set().union(*(p.keys() for p in partials))
    out = {}
    for k in keys:
        vals = [p[k] for p in partials]
        if k == "min":
            out[k] = np.float64(min(vals))
        elif k == "max":
            out[k] = np.float64(max(vals))
        else:  # sum / count accumulate
            out[k] = np.float64(sum(vals))
    return out


def _agg_combine(partials: list, fn: str, **_):
    if not partials:  # everything pruned/filtered: identity element
        return {"sum": 0.0, "count": 0.0, "min": float("inf"),
                "max": float("-inf"), "mean": 0.0}[fn]
    if fn == "sum":
        return float(sum(p["sum"] for p in partials))
    if fn == "count":
        return float(sum(p["count"] for p in partials))
    if fn == "min":
        return float(min(p["min"] for p in partials))
    if fn == "max":
        return float(max(p["max"] for p in partials))
    if fn == "mean":
        c = sum(p["count"] for p in partials)
        return float(sum(p["sum"] for p in partials) / max(c, 1.0))
    raise ValueError(fn)


# ---- multi-aggregate: N decomposable aggregates as ONE mergeable tail ----


def _magg_key(fn: str, col: str) -> str:
    return f"{fn}({col})"


def _magg_local(table, specs):
    """Partial = one agg partial per (fn, col) spec, keyed "fn(col)"."""
    return {_magg_key(fn, col): _agg_local(table, col, fn)
            for fn, col in specs}


def _magg_merge(partials: list, specs, **_):
    return {_magg_key(fn, col):
            _agg_merge([p[_magg_key(fn, col)] for p in partials], fn)
            for fn, col in specs}


def _magg_combine(partials: list, specs, **_):
    return {_magg_key(fn, col):
            _agg_combine([p[_magg_key(fn, col)] for p in partials], fn)
            for fn, col in specs}


# ---- holistic: exact median (NOT decomposable) ----


def _median_local(table, col: str):
    # the "local" part of a holistic op can only project its input column
    return {col: np.asarray(table[col]).ravel()}


def median_exact(columns: list[dict], col: str) -> float:
    allv = np.concatenate([p[col] for p in columns]) if columns else \
        np.zeros((0,))
    return float(np.median(allv)) if allv.size else float("nan")


# ---- decomposable approximation: fixed-bin quantile sketch ----


def _qsketch_local(table, col: str, lo: float, hi: float, bins: int = 1024):
    a = np.asarray(table[col], dtype=np.float64).ravel()
    hist, _ = np.histogram(a, bins=bins, range=(lo, hi))
    return {"hist": hist.astype(np.int32), "lo": lo, "hi": hi,
            "n": np.int64(a.size)}


def _qsketch_merge(partials: list, **_):
    """Histograms add; the merged sketch is shape-identical to a local
    one, so sketches merged per OSD combine exactly like raw partials."""
    return {"hist": np.sum([p["hist"] for p in partials],
                           axis=0).astype(np.int32),
            "lo": partials[0]["lo"], "hi": partials[0]["hi"],
            "n": np.int64(sum(int(p["n"]) for p in partials))}


def _qsketch_combine(partials: list, q: float = 0.5, **_):
    if not partials:
        return float("nan")
    hist = np.sum([p["hist"] for p in partials], axis=0)
    n = int(sum(int(p["n"]) for p in partials))
    lo, hi = partials[0]["lo"], partials[0]["hi"]
    if n == 0:
        return float("nan")
    cum = np.cumsum(hist)
    idx = int(np.searchsorted(cum, q * n))
    idx = min(idx, len(hist) - 1)
    edges = np.linspace(lo, hi, len(hist) + 1)
    return float(0.5 * (edges[idx] + edges[idx + 1]))


# ---- codecs as ops (paper's `compress` offload) ----


def _recompress(table, codecs: Mapping[str, str]):
    # physical transformation executed storage-side; returns a table
    # (the LocalVOL re-encodes with the new codecs on write-back)
    return table


register("select", OpImpl(_select, None, decomposable=True))
register("project", OpImpl(_project, None, decomposable=True))
register("filter", OpImpl(_filter, None, decomposable=True))
register("agg", OpImpl(
    _agg_local, _agg_combine, decomposable=True, table_out=False,
    merge=_agg_merge))
register("multi_agg", OpImpl(
    _magg_local, _magg_combine, decomposable=True, table_out=False,
    merge=_magg_merge))
register("median", OpImpl(
    _median_local, None, decomposable=False, table_out=False))
register("quantile_sketch", OpImpl(
    _qsketch_local, _qsketch_combine, decomposable=True, table_out=False,
    merge=_qsketch_merge))
register("recompress", OpImpl(_recompress, None, decomposable=True))


# ---- zero-decode packed-row select (server-local optimization, §3.3) ----


def select_packed(blob: bytes, rows: tuple[int, int], col: str) -> dict:
    """Slice whole rows out of a planar-bitpacked column WITHOUT decoding.

    Works because each row of a (S,)-shaped int column with S % 32 == 0
    occupies exactly S/32 word-groups: the OSD can serve a row range as a
    contiguous word slice.  The client (or the GPU shard) does the unpack
    — this is the storage-side `compress` offload staying compressed all
    the way down the wire and into HBM.
    """
    header = fmt.block_header(blob)
    if header["layout"] != "col":
        raise ValueError("select_packed needs col layout")
    import struct as _struct
    (hlen,) = _struct.unpack("<I", blob[4:8])
    off = 8 + hlen
    for c, blen in zip(header["columns"], header["lens"]):
        if c["name"] == col:
            if not c["codec"].startswith("bitpack"):
                raise ValueError(f"{col} is not bitpacked ({c['codec']})")
            bits = int(c["codec"][len("bitpack"):])
            shape = c["shape"]
            if len(shape) != 2 or shape[1] % 32:
                raise ValueError(f"need (n_rows, S%32==0), got {shape}")
            n_rows, S = shape
            gpr = S // 32                       # word-groups per row
            words = np.frombuffer(
                blob, np.uint32, count=n_rows * gpr * bits,
                offset=off).reshape(n_rows, gpr, bits)
            s, e = rows
            return {"packed": words[s:e].copy(),
                    "bits": np.int64(bits), "seq_len": np.int64(S)}
        off += blen
    raise KeyError(col)


register("select_packed", OpImpl(
    lambda *a, **k: None, None, decomposable=True, table_out=False))


# ---- OSD-resolved row ranges (pushed-down row-range pruning) ----


def _row_slice_unresolved(table, rows):
    raise ValueError(
        "row_slice carries GLOBAL dataset rows; resolve it against the "
        "object's extent first (resolve_row_slice — on the OSD, from "
        "its own 'rows' xattr)")


register("row_slice", OpImpl(_row_slice_unresolved, None,
                             decomposable=True))


def has_row_slice(ops: list[ObjOp]) -> bool:
    return any(o.name == "row_slice" for o in ops)


def resolve_row_slice(ops: list[ObjOp], extent: tuple[int, int],
                      clamp: bool = False) -> list[ObjOp] | None:
    """Rewrite every ``row_slice`` op (GLOBAL dataset rows) into this
    object's local ``select``, given the object's CURRENT extent
    ``(row_start, row_stop)`` — on the OSD from its own ``rows`` xattr,
    so a compiled plan keeps serving correct rows after the dataset is
    re-partitioned under it.  Returns None when a slice is provably
    disjoint from the extent (the object serves no rows — a
    prune-equivalent skip), unless ``clamp`` forces an empty
    ``select(0, 0)`` instead (positional responses need a result)."""
    out: list[ObjOp] = []
    for o in ops:
        if o.name != "row_slice":
            out.append(o)
            continue
        g0, g1 = (int(v) for v in o.params["rows"])
        s0, s1 = int(extent[0]), int(extent[1])
        lo, hi = max(g0, s0), min(g1, s1)
        if lo >= hi:
            if not clamp:
                return None
            lo = hi = s0
        out.append(op("select", rows=(lo - s0, hi - s0)))
    return out


# ---- OSD-resolved N-d hyperslab selection (dataspace pushdown) ----


def _hyperslab_unresolved(table, **_):
    raise ValueError(
        "hyperslab_slice carries a GLOBAL N-d selection; resolve it "
        "against the object's chunk extent first (resolve_hyperslab — "
        "on the OSD, from its own 'chunks' xattr)")


def _hyperslab_local(table, space, sel, chunk_start, cids):
    """Resolved executor: slice the selected cells out of this object's
    stacked ``(k, *chunk)`` block.  Emits a two-column table — ``cells``
    (the selected values, C-order per chunk piece) and ``chunk`` (the
    global chunk id of each cell) — because the block format requires
    equal-length columns; the client re-derives each piece's N-d
    placement from (selection ∩ chunk slab), so chunk-id runs are the
    only per-cell overhead on the wire.  Chunks are stored padded to the
    full chunk shape; selections never reach the pad because the
    intersection is clipped to the dataspace's logical shape."""
    sp = Dataspace.from_json(space)
    hs = Hyperslab.from_json(sel)
    data = np.asarray(table["data"])
    cells, ids = [], []
    for local in cids:
        cid = int(chunk_start) + int(local)
        r = hs.intersect_slab(sp.chunk_slab(cid))
        if r is None:
            continue
        locs, _offs, _counts = r
        piece = data[local][tuple(slice(*l) for l in locs)]
        cells.append(np.ascontiguousarray(piece).ravel())
        ids.append(np.full(piece.size, cid, dtype=np.int32))
    if cells:
        return {"cells": np.concatenate(cells),
                "chunk": np.concatenate(ids)}
    return {"cells": np.zeros(0, dtype=np.dtype(sp.dtype)),
            "chunk": np.zeros(0, dtype=np.int32)}


register("hyperslab_slice", OpImpl(_hyperslab_unresolved, None,
                                   decomposable=True))
register("hyperslab_local", OpImpl(_hyperslab_local, None,
                                   decomposable=True))


def has_hyperslab(ops: list[ObjOp]) -> bool:
    return any(o.name == "hyperslab_slice" for o in ops)


def resolve_hyperslab(ops: list[ObjOp], chunks: tuple[int, int],
                      chunk_zone_maps=None, where=None,
                      clamp: bool = False
                      ) -> tuple[list[ObjOp] | None, int]:
    """Rewrite every ``hyperslab_slice`` op (GLOBAL N-d selection) into
    this object's local ``hyperslab_local``, given the object's CURRENT
    chunk extent ``[chunk_start, chunk_stop)`` — on the OSD from its own
    ``chunks`` xattr, the same late-binding contract as
    :func:`resolve_row_slice`, so a compiled plan keeps serving correct
    cells after the array is re-chunked/re-partitioned under it.

    ``chunk_zone_maps`` (per-LOCAL-chunk zone maps from the object's
    xattrs, computed over UNPADDED chunk values) plus the request's
    ``where`` prune expression drop whole chunks before any cell is
    touched; the count of dropped chunks is returned so the serve layer
    can meter OSD-side chunk pruning.  Returns ``(None, n_pruned)``
    when the object serves no cells (disjoint selection, or every
    intersecting chunk pruned) — a prune-equivalent skip — unless
    ``clamp`` forces an empty result instead (positional responses)."""
    pred = ex.ensure_pred(where)
    out: list[ObjOp] = []
    n_pruned = 0
    served_any = False
    for o in ops:
        if o.name != "hyperslab_slice":
            out.append(o)
            continue
        sp = Dataspace.from_json(o.params["space"])
        hs = Hyperslab.from_json(o.params["sel"])
        c0, c1 = int(chunks[0]), int(chunks[1])
        cids = [cid for cid in sp.chunk_ids_overlapping(hs)
                if c0 <= cid < c1]
        if pred is not None and chunk_zone_maps is not None:
            kept = []
            for cid in cids:
                zm = chunk_zone_maps[cid - c0]
                if zm is not None and pred.prunes(zm):
                    n_pruned += 1
                else:
                    kept.append(cid)
            cids = kept
        served_any = served_any or bool(cids)
        out.append(op("hyperslab_local", space=o.params["space"],
                      sel=o.params["sel"], chunk_start=c0,
                      cids=[cid - c0 for cid in cids]))
    if not served_any and not clamp:
        return None, n_pruned
    return out, n_pruned


# --------------------------------------------------------------------------
# zone-map pruning (shared by the client planner and the OSDs)
# --------------------------------------------------------------------------


def normalize_exprs(ops: list[ObjOp]) -> list[ObjOp]:
    """Parse each ``filter`` op's serialized expression ONCE per
    request (wire dict -> Expr), so per-object evaluation and column
    analysis reuse the parsed tree instead of re-parsing it per
    object."""
    out: list[ObjOp] = []
    for o in ops:
        e = o.params.get("expr") if o.name == "filter" else None
        if e is not None and not isinstance(e, ex.Expr):
            o = ObjOp(o.name, {**o.params, "expr": ex.ensure(e)})
        out.append(o)
    return out


def filter_predicates(ops: list[ObjOp]) -> ex.Expr | None:
    """The conjunction of every ``filter`` op's expression tree — the
    ONE predicate a prune decision consults (None: no filters)."""
    return ex.conj_all(_filter_expr(o.params)
                       for o in ops if o.name == "filter")


def zone_map_prunes(zone_map: Mapping, predicates) -> bool:
    """True when the zone map PROVES the filter expression matches no
    row of the object — interval arithmetic over the predicate tree
    (``expr.Expr.prunes``): a leaf prunes when its [lo, hi] interval is
    disjoint from the matching set, ``And`` prunes if ANY child prunes,
    ``Or`` only if ALL children prune, ``Not``/unknown leaves never
    prune — conservative by construction.

    This is the one prune rule in the system: ``GlobalVOL.plan`` applies
    it to cached zone maps (client-side prune) and ``OSD.exec_cls_batch``
    applies it to the object's CURRENT xattrs (pushed-down prune), so
    the two strategies always agree on identical metadata.
    ``predicates`` may be an :class:`~repro_torch.core.expr.Expr`, its wire
    dict, or the legacy iterable of (col, cmp, value) triples.
    """
    pred = ex.ensure_pred(predicates)
    return pred is not None and pred.prunes(zone_map)


# --------------------------------------------------------------------------
# pipeline execution (runs ON the OSD — see core.store)
# --------------------------------------------------------------------------


def pipeline_decomposable(ops: list[ObjOp]) -> bool:
    return all(get_impl(o.name).decomposable for o in ops)


def pipeline_mergeable(ops: list[ObjOp]) -> bool:
    """True when per-object partials can be folded server-side: the whole
    pipeline is decomposable and the tail emits partials with an
    associative ``merge`` — the precondition for the per-OSD combine
    (one partial per OSD request instead of one per object)."""
    if not ops:
        return False
    tail = get_impl(ops[-1].name)
    return (pipeline_decomposable(ops) and not tail.table_out
            and tail.combine is not None and tail.merge is not None)


def merge_partials(ops: list[ObjOp], partials: list) -> Any:
    """Server-side (per-OSD) fold: partials -> ONE same-shaped partial."""
    tail = ops[-1]
    impl = get_impl(tail.name)
    if impl.merge is None:
        raise ValueError(f"{tail.name} has no partial merge")
    return impl.merge(partials, **tail.params)


# ops whose column needs are fully described by a single "col" param
_SINGLE_COL_OPS = frozenset({"agg", "median", "quantile_sketch"})
# ops that touch no columns at all (pure row-range slicing)
_COL_FREE_OPS = frozenset({"select", "row_slice"})


def required_columns(ops: list[ObjOp]) -> list[str] | None:
    """Minimal column set a pipeline needs decoded, or None for "all".

    The whole pipeline is analyzed — not just a leading ``project`` — so
    a filter→agg scan decodes only the filter and aggregate columns.
    Returns None (decode everything) when the pipeline's *output* is the
    full table (table-out tail with no projection) or when it contains
    an op we cannot analyze (e.g. ``recompress``), which keeps results
    bit-identical to the full-decode path in every case.
    """
    if not ops:
        return None
    needed: set[str] = set()
    have_project = False
    for o in ops:
        if o.name in _COL_FREE_OPS:
            continue
        if o.name == "project":
            needed.update(o.params["cols"])
            have_project = True
            continue
        if o.name == "filter":
            needed.update(_filter_expr(o.params).columns())
            continue
        if o.name in _SINGLE_COL_OPS:
            needed.add(o.params["col"])
            continue
        if o.name == "multi_agg":
            needed.update(col for _, col in o.params["specs"])
            continue
        return None  # unknown/pass-through op: be conservative
    tail = get_impl(ops[-1].name)
    if tail.table_out and not have_project:
        return None  # output carries every column: decode all
    return sorted(needed)


def decode_pipeline(blob: bytes, ops: list[ObjOp]) -> dict:
    """The decode half of :func:`run_pipeline`: the minimal column
    table the pipeline needs, straight from the block.  Split out so
    the OSD result cache can keep decoded column sets around and feed
    them back through :func:`apply_pipeline` without touching the blob
    again (the decode is the service cost the cache elides)."""
    return fmt.decode_block(blob, columns=required_columns(ops))


def apply_pipeline(table: dict, ops: list[ObjOp],
                   encode: bool = True) -> Any:
    """The post-decode half of :func:`run_pipeline`: run the op chain
    over an already-decoded column table.  Every built-in op builds a
    NEW dict (slices/masks/partials) and never mutates its input, so a
    cached table can be replayed through any number of pipelines."""
    out: Any = table
    for o in ops:
        impl = get_impl(o.name)
        if not impl.table_in and not isinstance(out, dict):
            raise TypeError(f"{o.name}: pipeline type mismatch")
        out = impl.local(out, **o.params)
        if not impl.table_out:
            return out  # partial; must be the last op
    return fmt.encode_block(out) if encode else out


def run_pipeline(blob: bytes, ops: list[ObjOp], encode: bool = True) -> Any:
    """Execute a pipeline against one object's block, server-side.

    Returns either an encoded table block (table-out pipelines) or a
    partial (dict of small ndarrays) for aggregate tails.  Column
    pruning is computed from the *whole* pipeline (filter cols + agg /
    median / sketch cols + projection — :func:`required_columns`) and
    pushed into block decoding, so a filter→agg scan never decodes
    untouched columns (col layout).  Bitpack columns decode through the
    CUDA kernel (``kernels/bitunpack``) by default, or through the
    backend ``format.set_bitunpack_backend`` selects.

    ``encode=False`` returns a table-out result as the raw column dict
    instead of an encoded block — the per-OSD concat path uses it to
    fold many result tables into ONE framed block without a redundant
    encode/decode round per object.
    """
    if ops and ops[0].name == "select_packed":
        if len(ops) != 1:
            raise ValueError("select_packed must be the only op")
        return select_packed(blob, **ops[0].params)
    return apply_pipeline(decode_pipeline(blob, ops), ops, encode=encode)


def _canon(v: Any) -> Any:
    """Canonical JSON-able form of one op-param value: Exprs flatten to
    their wire dicts, numpy scalars/arrays to plain lists, tuples to
    lists — so a pipeline built from wire dicts and its normalized
    (parsed-Expr) twin digest identically."""
    if isinstance(v, ex.Expr):
        return v.to_json()
    if isinstance(v, Mapping):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def pipeline_digest(ops: list[ObjOp]) -> str:
    """A stable content digest of one pipeline — the pipeline/columns
    half of the OSD result-cache key ``(name, version, digest)``.  Two
    pipelines digest equal iff their canonical serialized forms match,
    so a shared-plan re-scan hits while any changed filter value,
    projection, or row range misses."""
    payload = [{"name": o.name, "params": _canon(o.params)} for o in ops]
    return hashlib.sha1(
        json.dumps(payload, sort_keys=True, separators=(",", ":"),
                   default=repr).encode()).hexdigest()


def compact_merge(blobs: list[bytes], *, layout: str = "col",
                  codecs: Mapping[str, str] | None = None
                  ) -> tuple[bytes, dict]:
    """OSD-side small-object merge: fold a run of consecutive blocks
    into ONE re-encoded block (row order preserved) and return it with
    the merged table's zone map.  The maintenance plane's compactor uses
    this to collapse one-blob-per-append ``ckpt``/kvcache runs into
    target-sized objects without the rows ever leaving the storage side;
    codecs are re-derived for the merged value range
    (``format.auto_codecs``) unless pinned by the caller."""
    if not blobs:
        raise ValueError("compact_merge of zero blocks")
    tables = [fmt.decode_block(b) for b in blobs]
    keys = list(tables[0].keys())
    for t in tables[1:]:
        if list(t.keys()) != keys:
            raise ValueError("compact_merge: schema mismatch across run")
    merged = {k: np.concatenate([np.asarray(t[k]) for t in tables],
                                axis=0)
              for k in keys}
    blob = fmt.encode_block(
        merged, layout=layout,
        codecs=codecs if codecs is not None else fmt.auto_codecs(merged))
    return blob, fmt.zone_map(merged)


def _compact_unresolved(table, **_):
    raise ValueError(
        "compact_merge folds whole encoded blocks, not one object's "
        "table; it is dispatched via OSD.compact_merge by the "
        "maintenance plane, never through a scan pipeline")


register("compact_merge", OpImpl(_compact_unresolved, None,
                                 decomposable=False, table_out=False))


def concat_encode(tables: list[Mapping[str, np.ndarray]]) -> bytes:
    """Server-side table concat: fold result tables into ONE encoded
    block (item order preserved) — the table-out analogue of
    ``merge_partials``."""
    keys = list(tables[0].keys())
    return fmt.encode_block(
        {k: np.concatenate([np.asarray(t[k]) for t in tables], axis=0)
         for k in keys})


def table_n_rows(table: Mapping[str, np.ndarray]) -> int:
    for v in table.values():
        return int(np.asarray(v).shape[0])
    return 0


def combine_partials(ops: list[ObjOp], partials: list) -> Any:
    """Client/driver-side combine for the pipeline's terminal op."""
    tail = ops[-1]
    impl = get_impl(tail.name)
    if impl.table_out:
        raise ValueError("pipeline ends in a table; use concat instead")
    if impl.combine is None:
        raise ValueError(f"{tail.name} is holistic — no combine; gather "
                         "its projected inputs and compute centrally")
    return impl.combine(partials, **tail.params)
