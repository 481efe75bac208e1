"""Pass (e): objclass registry completeness.

Runtime (not AST) checks over ``repro_torch.core.objclass._REGISTRY`` — the
registry is data, so the honest check is to interrogate the real one:

* every registered op has **representative params** declared here and
  survives a wire round trip (``to_json -> json -> from_json``) with an
  identical pipeline digest — an op that can't cross the wire can't be
  pushed down;
* every op either rides a server-side merge plane (``exec_combine``:
  decomposable + combine + merge, partial-out) or the concat plane
  (table-out), **or** is explicitly declared not mergeable;
* every op's column needs are either analyzable by
  ``required_columns`` (single-col / col-free / project-filter shapes)
  **or** explicitly declared conservative (full-decode / blob-level).

The declaration sets make silence impossible: registering a new op
without updating them is a finding, and a declaration that a later
change makes stale (the op *became* mergeable) is a finding too.
All tables are injectable for the linter's own tests.
"""

from __future__ import annotations

import json

from repro_torch.analysis.base import Finding

_FILE = "src/repro_torch/core/objclass.py"

# representative params per op: minimal, JSON-able, shaped like real
# call sites (scan planner / hyperslab resolver / compaction)
REP_PARAMS: dict[str, dict] = {
    "select": {"rows": (0, 4)},
    "project": {"cols": ["x"]},
    "filter": {"col": "x", "cmp": ">", "value": 0.0},
    "agg": {"col": "x", "fn": "sum"},
    "multi_agg": {"specs": [["sum", "x"], ["min", "y"]]},
    "median": {"col": "x"},
    "quantile_sketch": {"col": "x", "q": 0.5},
    "recompress": {"codecs": {"x": "raw"}},
    "select_packed": {"rows": (0, 4), "col": "x"},
    "row_slice": {"rows": (0, 4)},
    "hyperslab_slice": {"space": {"shape": [8, 8], "chunk": [4, 4],
                                  "dtype": "float32"},
                        "sel": {"start": [0, 0], "count": [2, 2]}},
    "hyperslab_local": {"space": {"shape": [8, 8], "chunk": [4, 4],
                                  "dtype": "float32"},
                        "sel": {"start": [0, 0], "count": [2, 2]},
                        "chunk_start": 0, "cids": [0]},
    "compact_merge": {"out_layout": "col"},
}

# holistic / blob-level / placeholder-local ops that ride neither the
# combine plane nor the concat plane — each needs a reason to stay here
KNOWN_NOT_MERGEABLE: frozenset[str] = frozenset({
    "median",          # holistic: exact median has no associative partial
    "select_packed",   # partial-out blob slice; client-side unpack only
    "compact_merge",   # consumes N source blobs, not a table stream
})

# ops whose column needs required_columns() cannot narrow — declared
# conservative (full decode / blob-level), so a pipeline containing one
# correctly falls back to fetching every column
KNOWN_COL_CONSERVATIVE: frozenset[str] = frozenset({
    "recompress",        # rewrites every column's codec
    "select_packed",     # blob-level; bypasses the decoded table
    "hyperslab_slice",   # N-d cell selection over the stacked block
    "hyperslab_local",
    "compact_merge",     # whole-object rewrite
})


def check_registry(*, reps: dict | None = None,
                   not_mergeable: frozenset | None = None,
                   col_conservative: frozenset | None = None,
                   ops: tuple[str, ...] | None = None) -> list[Finding]:
    from repro_torch.core import objclass as oc

    reps = REP_PARAMS if reps is None else reps
    not_mergeable = KNOWN_NOT_MERGEABLE if not_mergeable is None \
        else not_mergeable
    col_conservative = KNOWN_COL_CONSERVATIVE \
        if col_conservative is None else col_conservative
    ops = oc.registered_ops() if ops is None else ops

    analyzable = (set(oc._SINGLE_COL_OPS) | set(oc._COL_FREE_OPS)
                  | {"project", "filter", "multi_agg"})

    findings: list[Finding] = []

    def flag(name: str, msg: str) -> None:
        findings.append(Finding("registry", _FILE, 1,
                                f"op:{name}", msg))

    for name in ops:
        impl = oc.get_impl(name)

        # -- wire round trip over representative params
        rep = reps.get(name)
        if rep is None:
            flag(name, "no representative params declared "
                       "(REP_PARAMS) — wire round trip unchecked")
        else:
            o = oc.ObjOp(name, rep)
            try:
                wire = json.loads(json.dumps(o.to_json()))
                back = oc.ObjOp.from_json(wire)
                ok = (back.name == o.name
                      and oc.pipeline_digest([back])
                      == oc.pipeline_digest([o]))
            except Exception as e:        # noqa: BLE001 - report, don't die
                ok = False
                flag(name, f"wire round trip raised {e!r}")
            else:
                if not ok:
                    flag(name, "wire round trip changed the op "
                               "(digest mismatch after "
                               "to_json -> json -> from_json)")

        # -- merge-plane coverage
        combinable = (impl.decomposable and not impl.table_out
                      and impl.combine is not None
                      and impl.merge is not None)
        concatable = impl.table_out
        if not (combinable or concatable) \
                and name not in not_mergeable:
            flag(name, "neither combine-plane capable (decomposable + "
                       "combine + merge, partial-out) nor table-out, "
                       "and not declared in KNOWN_NOT_MERGEABLE")
        if (combinable or concatable) and name in not_mergeable:
            flag(name, "declared KNOWN_NOT_MERGEABLE but actually "
                       "rides a merge/concat plane — stale "
                       "declaration")

        # -- required_columns coverage
        if name not in analyzable \
                and name not in col_conservative:
            flag(name, "required_columns() cannot analyze this op and "
                       "it is not declared in KNOWN_COL_CONSERVATIVE")
        if name in analyzable and name in col_conservative:
            flag(name, "declared KNOWN_COL_CONSERVATIVE but "
                       "required_columns() analyzes it — stale "
                       "declaration")

    return findings
