"""Predicate-expression algebra — ONE filter language for every layer
(paper §3.2; Skyhook-style rich pushdown filters).

A predicate is an immutable tree of :class:`Expr` nodes::

    Or((Cmp("run", "<", 10), Cmp("run", ">", 90))) & Cmp("hits", ">=", 3)

and the SAME tree serves three roles:

  * **evaluation** — ``expr.mask(table)`` walks the tree producing one
    vectorized numpy row mask per leaf and combining them with mask
    algebra per node; the OSD's ``filter`` objclass op is exactly this
    walk;
  * **pruning** — ``expr.prunes(zone_map)`` decides, by interval
    arithmetic over the object's per-column [lo, hi] zone map, whether
    the object PROVABLY matches no row.  The rule is conservative by
    construction: a leaf prunes only when its interval is disjoint from
    the matching set, ``And`` prunes if ANY child prunes, ``Or`` only
    if ALL children prune, and ``Not`` / unknown leaves never prune.
    The one rule is shared verbatim by the client planner
    (``GlobalVOL.plan``) and the OSDs (``OSD.exec_cls_batch``), so
    ``prune="client"`` and ``prune="pushdown"`` agree bit-exactly on
    identical metadata;
  * **transport** — ``to_json()``/``from_json()`` give the wire form
    that rides inside ``ObjOp`` params and the batched request's
    ``prune`` field, so a rich filter costs the same K round trips as a
    flat one.

Every comparison operator is defined ONCE, in :data:`CMP_TABLE`: a
:class:`Comparator` carries BOTH its vectorized evaluator and its
interval prune rule as required fields, so adding an operator without
teaching every layer is a construction-time ``TypeError`` — not a
silent never-prune on the client or a ``KeyError`` on the OSD.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import numpy as np


# --------------------------------------------------------------------------
# the ONE comparator table
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Comparator:
    """One comparison operator for every layer that needs it: ``fn`` is
    the vectorized evaluator (``mask = fn(column, value)``), ``prunes``
    the interval rule (does a [lo, hi] zone PROVE no value matches?).
    Both are required fields on purpose — a half-defined operator
    cannot be registered."""

    fn: Callable[..., np.ndarray]
    prunes: Callable[[Any, Any, Any], bool]


CMP_TABLE: dict[str, Comparator] = {
    "<":  Comparator(np.less,          lambda lo, hi, v: lo >= v),
    "<=": Comparator(np.less_equal,    lambda lo, hi, v: lo > v),
    ">":  Comparator(np.greater,       lambda lo, hi, v: hi <= v),
    ">=": Comparator(np.greater_equal, lambda lo, hi, v: hi < v),
    "==": Comparator(np.equal,         lambda lo, hi, v: v < lo or v > hi),
    # a zone can prove != empty only when EVERY row equals the value
    "!=": Comparator(np.not_equal,     lambda lo, hi, v: lo == v == hi),
}

COMPARATORS = tuple(CMP_TABLE)


def _rows(mask) -> np.ndarray:
    """Reduce a leaf's elementwise mask to a 1-D row mask: a row of a
    multi-dim column matches when ANY of its elements does (each leaf
    reduces independently, so leaves over different-shaped columns
    still combine)."""
    mask = np.asarray(mask)
    if mask.ndim > 1:
        mask = mask.any(axis=tuple(range(1, mask.ndim)))
    return mask


def _sound(prune_fn, rng, *args) -> bool:
    """A leaf prunes only when its zone interval PROVES emptiness; a
    missing, malformed, or type-mismatched interval proves nothing."""
    if not rng:
        return False
    try:
        lo, hi = rng
        return bool(prune_fn(lo, hi, *args))
    except TypeError:  # e.g. string zone vs numeric value
        return False


def _py(v):
    """JSON-able scalar (numpy scalars -> python)."""
    return v.item() if isinstance(v, np.generic) else v


# --------------------------------------------------------------------------
# the expression tree
# --------------------------------------------------------------------------


class Expr:
    """Base of the immutable predicate tree.  Subclasses implement
    ``mask`` (vectorized evaluation -> 1-D row mask), ``prunes``
    (conservative zone-map interval proof), ``columns`` and
    ``to_json``.  ``&``/``|``/``~`` compose trees fluently."""

    def mask(self, table: Mapping[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def prunes(self, zone_map: Mapping) -> bool:
        return False  # conservative default (Not, unknown leaves)

    def columns(self) -> frozenset:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    def __and__(self, other) -> "Expr":
        return conj(self, ensure(other))

    def __or__(self, other) -> "Expr":
        return Or((self, ensure(other)))

    def __invert__(self) -> "Expr":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    """A constant predicate — the residue of constant folding.  True
    matches every row (and never prunes); False matches none (and
    soundly prunes ANY object, zone map or not)."""

    value: bool

    def mask(self, table):
        n = 0
        for v in table.values():
            n = int(np.asarray(v).shape[0])
            break
        return np.full(n, bool(self.value), dtype=bool)

    def prunes(self, zone_map):
        return not self.value

    def columns(self):
        return frozenset()

    def to_json(self):
        return {"t": "const", "value": bool(self.value)}


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    """``col <cmp> value`` — one :data:`CMP_TABLE` comparison."""

    col: str
    cmp: str
    value: Any

    def __post_init__(self):
        if self.cmp not in CMP_TABLE:
            raise ValueError(f"bad comparator {self.cmp!r}; "
                             f"known: {COMPARATORS}")

    def mask(self, table):
        return _rows(CMP_TABLE[self.cmp].fn(np.asarray(table[self.col]),
                                            self.value))

    def prunes(self, zone_map):
        return _sound(CMP_TABLE[self.cmp].prunes, zone_map.get(self.col),
                      self.value)

    def columns(self):
        return frozenset((self.col,))

    def to_json(self):
        return {"t": "cmp", "col": self.col, "cmp": self.cmp,
                "value": _py(self.value)}


@dataclasses.dataclass(frozen=True)
class In(Expr):
    """``col IN values`` — membership in a finite list."""

    col: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))

    def mask(self, table):
        return _rows(np.isin(np.asarray(table[self.col]),
                             list(self.values)))

    def prunes(self, zone_map):
        # prune iff every candidate value is outside [lo, hi]; an empty
        # IN-list matches nothing, so it vacuously (and soundly) prunes
        return _sound(
            lambda lo, hi: all(v < lo or v > hi for v in self.values),
            zone_map.get(self.col))

    def columns(self):
        return frozenset((self.col,))

    def to_json(self):
        return {"t": "in", "col": self.col,
                "values": [_py(v) for v in self.values]}


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    """``lo <= col <= hi`` (inclusive both ends)."""

    col: str
    lo: Any
    hi: Any

    def mask(self, table):
        a = np.asarray(table[self.col])
        return _rows(np.greater_equal(a, self.lo)
                     & np.less_equal(a, self.hi))

    def prunes(self, zone_map):
        return _sound(lambda zlo, zhi: zhi < self.lo or zlo > self.hi,
                      zone_map.get(self.col))

    def columns(self):
        return frozenset((self.col,))

    def to_json(self):
        return {"t": "between", "col": self.col, "lo": _py(self.lo),
                "hi": _py(self.hi)}


@dataclasses.dataclass(frozen=True)
class StrPrefix(Expr):
    """``col.startswith(prefix)`` over a string column (zone maps store
    string min/max, so prefix scans prune like range scans)."""

    col: str
    prefix: str

    def mask(self, table):
        a = np.asarray(table[self.col])
        if a.dtype.kind != "S":
            a = a.astype(np.str_)
        return _rows(np.char.startswith(
            a, self.prefix.encode() if a.dtype.kind == "S"
            else self.prefix))

    def prunes(self, zone_map):
        # matching strings live in [prefix, prefix∙∞): everything below
        # prefix, or everything above the last string with that prefix,
        # proves emptiness
        def rule(lo, hi):
            if hi < self.prefix:
                return True
            return lo > self.prefix and not str(lo).startswith(self.prefix)
        return _sound(rule, zone_map.get(self.col))

    def columns(self):
        return frozenset((self.col,))

    def to_json(self):
        return {"t": "prefix", "col": self.col, "prefix": self.prefix}


def _check_children(children):
    if not children:
        raise ValueError("And/Or need at least one child")
    for c in children:
        if not isinstance(c, Expr):
            raise TypeError(f"child {c!r} is not an Expr (use ensure())")


@dataclasses.dataclass(frozen=True)
class And(Expr):
    """Conjunction: a row matches when EVERY child matches; an object
    prunes when ANY child's interval proof empties it."""

    children: tuple

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))
        _check_children(self.children)

    def mask(self, table):
        out = self.children[0].mask(table)
        for c in self.children[1:]:
            out = out & c.mask(table)
        return out

    def prunes(self, zone_map):
        return any(c.prunes(zone_map) for c in self.children)

    def columns(self):
        return frozenset().union(*(c.columns() for c in self.children))

    def to_json(self):
        return {"t": "and",
                "children": [c.to_json() for c in self.children]}


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    """Disjunction: a row matches when ANY child matches; an object
    prunes only when EVERY child's interval proof empties it."""

    children: tuple

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))
        _check_children(self.children)

    def mask(self, table):
        out = self.children[0].mask(table)
        for c in self.children[1:]:
            out = out | c.mask(table)
        return out

    def prunes(self, zone_map):
        return all(c.prunes(zone_map) for c in self.children)

    def columns(self):
        return frozenset().union(*(c.columns() for c in self.children))

    def to_json(self):
        return {"t": "or",
                "children": [c.to_json() for c in self.children]}


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    """Negation.  NEVER prunes: a zone map bounds what values exist,
    not what values are absent, so no interval can prove a negation
    empty (``prunes`` stays the base class's conservative False)."""

    child: Expr

    def __post_init__(self):
        if not isinstance(self.child, Expr):
            raise TypeError(f"Not needs an Expr, got {self.child!r}")

    def mask(self, table):
        return ~self.child.mask(table)

    def columns(self):
        return self.child.columns()

    def to_json(self):
        return {"t": "not", "child": self.child.to_json()}


# --------------------------------------------------------------------------
# construction / normalization / wire form
# --------------------------------------------------------------------------


_FROM_JSON: dict[str, Callable[[dict], Expr]] = {
    "const": lambda d: Const(bool(d["value"])),
    "cmp": lambda d: Cmp(d["col"], d["cmp"], d["value"]),
    "in": lambda d: In(d["col"], tuple(d["values"])),
    "between": lambda d: Between(d["col"], d["lo"], d["hi"]),
    "prefix": lambda d: StrPrefix(d["col"], d["prefix"]),
    "and": lambda d: And(tuple(from_json(c) for c in d["children"])),
    "or": lambda d: Or(tuple(from_json(c) for c in d["children"])),
    "not": lambda d: Not(from_json(d["child"])),
}


def from_json(d: Mapping) -> Expr:
    """Rebuild a tree from its wire form (see ``Expr.to_json``)."""
    try:
        build = _FROM_JSON[d["t"]]
    except KeyError:
        raise ValueError(f"unknown expression node {d.get('t')!r}; "
                         f"known: {sorted(_FROM_JSON)}") from None
    return build(d)


def ensure(x) -> Expr:
    """Normalize one predicate spec: an :class:`Expr`, its serialized
    dict, or a legacy ``(col, cmp, value)`` triple."""
    if isinstance(x, Expr):
        return x
    if isinstance(x, Mapping):
        return from_json(x)
    if isinstance(x, (tuple, list)) and len(x) == 3:
        return Cmp(x[0], x[1], x[2])
    raise TypeError(f"not a predicate: {x!r} (want an Expr, its JSON "
                    "form, or a (col, cmp, value) triple)")


def ensure_pred(p) -> Expr | None:
    """Normalize a whole pushdown-prune payload: None, one Expr, its
    wire dict, or the legacy iterable of (col, cmp, value) triples
    (conjunction).  Returns None when there is nothing to prune on."""
    if p is None or isinstance(p, Expr):
        return p
    if isinstance(p, Mapping):
        return from_json(p)
    return conj_all(ensure(t) for t in p)


def conj(a: Expr | None, b: Expr) -> Expr:
    """AND-compose, flattening nested ``And`` nodes (so N fluent
    ``.filter`` calls build one flat conjunction, not a left spine)."""
    if a is None:
        return b
    left = a.children if isinstance(a, And) else (a,)
    right = b.children if isinstance(b, And) else (b,)
    return And(left + right)


def conj_all(exprs: Iterable[Expr]) -> Expr | None:
    out: Expr | None = None
    for e in exprs:
        out = conj(out, e)
    return out


# --------------------------------------------------------------------------
# normalization (prune-path rewriting)
# --------------------------------------------------------------------------

# each comparator's exact complement — the engine of De Morgan push-down
_NEG_CMP = {"<": ">=", "<=": ">", ">": "<=", ">=": "<",
            "==": "!=", "!=": "=="}

# cmp -> (is_lower_bound, strict) for the interval-merging pass
_BOUND = {">": (True, True), ">=": (True, False),
          "<": (False, True), "<=": (False, False)}


def normalize(e: Expr | None) -> Expr | None:
    """Rewrite a tree into an equivalent, more prunable one:

      * **De Morgan push-down** — ``Not`` sinks to the leaves, where it
        dissolves into the complement comparator (``~(x < 5)`` becomes
        ``x >= 5``); since ``Not`` never prunes but every comparator
        does, a pushed-down tree prunes where the original could not;
      * **constant folding** — empty ``In`` lists, inverted ``Between``
        bounds, and dominated ``And``/``Or`` children collapse to
        :class:`Const`;
      * **same-column interval merging** — interval leaves on one
        column inside a conjunction fuse into the tightest interval
        (``x > 2 AND x > 5`` -> ``x > 5``; ``x > 5 AND x < 1`` ->
        ``Const(False)``; closed bounds fuse into one ``Between``).

    Caveats, by design: the rewrite assumes a total order on compared
    values (predicates over NaN-holding float columns are not made
    worse — merging skips non-finite constants — but NaN rows already
    defeat zone pruning) and interval *contradiction* folding assumes
    scalar per-row values (for multi-element rows the per-leaf
    any-element reduction makes opposing bounds satisfiable, so the
    scan layer only normalizes prune payloads over scalar zone
    metadata, never evaluation filters)."""
    if e is None:
        return None
    return _norm(e, neg=False)


def _mergeable(v) -> bool:
    if isinstance(v, bool):
        return False  # bools order like ints but folding them is noise
    if isinstance(v, (int, np.integer)):
        return True
    if isinstance(v, (float, np.floating)):
        return bool(np.isfinite(v))
    return isinstance(v, str)


def _norm(e: Expr, neg: bool) -> Expr:
    if isinstance(e, Const):
        return Const(e.value != neg)
    if isinstance(e, Cmp):
        return Cmp(e.col, _NEG_CMP[e.cmp], e.value) if neg else e
    if isinstance(e, Between):
        try:
            empty = e.lo > e.hi
        except TypeError:
            empty = False
        if empty:
            return Const(neg)
        if neg:  # ~(lo <= x <= hi)  ==  x < lo OR x > hi
            return Or((Cmp(e.col, "<", e.lo), Cmp(e.col, ">", e.hi)))
        return e
    if isinstance(e, In):
        if not e.values:
            return Const(neg)  # IN () matches nothing
        return Not(e) if neg else e
    if isinstance(e, Not):
        return _norm(e.child, not neg)
    if not isinstance(e, (And, Or)):       # StrPrefix, future leaves
        return Not(e) if neg else e
    is_and = isinstance(e, And) != neg     # De Morgan flips the node
    flat: list[Expr] = []
    for c in e.children:
        k = _norm(c, neg)
        if isinstance(k, And if is_and else Or):
            flat.extend(k.children)
        elif isinstance(k, Const):
            if k.value != is_and:          # dominating constant
                return Const(not is_and)
        else:                              # identity constant: dropped
            flat.append(k)
    kids: list[Expr] = []
    for k in flat:                         # dedup, order-preserving
        if k not in kids:
            kids.append(k)
    if is_and:
        kids = _merge_intervals(kids)
        if kids is None:
            return Const(False)
    if not kids:
        return Const(is_and)               # empty And ≡ True, Or ≡ False
    if len(kids) == 1:
        return kids[0]
    return (And if is_and else Or)(tuple(kids))


def _merge_intervals(kids: list[Expr]) -> list[Expr] | None:
    """Fuse same-column interval leaves of a conjunction; None means a
    provable contradiction (the conjunction is Const(False))."""
    by_col: dict[str, list[Expr]] = {}
    for k in kids:
        if (isinstance(k, Cmp) and k.cmp in _BOUND
                and _mergeable(k.value)) or \
           (isinstance(k, Cmp) and k.cmp == "=="
                and _mergeable(k.value)) or \
           (isinstance(k, Between) and _mergeable(k.lo)
                and _mergeable(k.hi)):
            by_col.setdefault(k.col, []).append(k)
    out: list[Expr] = []
    done: set[int] = set()
    for col, leaves in by_col.items():
        if len(leaves) < 2:
            continue  # nothing to fuse; leave the leaf in place
        try:
            fused = _fuse(col, leaves)
        except TypeError:  # mixed value types: leave unmerged
            continue
        if fused is None:
            return None
        done.update(id(l) for l in leaves)
        out.extend(fused)
    return [k for k in kids if id(k) not in done] + out


def _fuse(col: str, leaves: list[Expr]) -> list[Expr] | None:
    lo = hi = None  # (value, strict)

    def tighter_lo(a, b):
        return b if a is None or b[0] > a[0] \
            or (b[0] == a[0] and b[1] and not a[1]) else a

    def tighter_hi(a, b):
        return b if a is None or b[0] < a[0] \
            or (b[0] == a[0] and b[1] and not a[1]) else a

    for l in leaves:
        if isinstance(l, Between):
            lo = tighter_lo(lo, (l.lo, False))
            hi = tighter_hi(hi, (l.hi, False))
        elif l.cmp == "==":
            lo = tighter_lo(lo, (l.value, False))
            hi = tighter_hi(hi, (l.value, False))
        else:
            is_lo, strict = _BOUND[l.cmp]
            if is_lo:
                lo = tighter_lo(lo, (l.value, strict))
            else:
                hi = tighter_hi(hi, (l.value, strict))
    if lo is not None and hi is not None:
        if lo[0] > hi[0] or (lo[0] == hi[0] and (lo[1] or hi[1])):
            return None  # empty interval: contradiction
        if lo[0] == hi[0]:
            return [Cmp(col, "==", lo[0])]
        if not lo[1] and not hi[1]:
            return [Between(col, lo[0], hi[0])]
    out: list[Expr] = []
    if lo is not None:
        out.append(Cmp(col, ">" if lo[1] else ">=", lo[0]))
    if hi is not None:
        out.append(Cmp(col, "<" if hi[1] else "<=", hi[0]))
    return out
