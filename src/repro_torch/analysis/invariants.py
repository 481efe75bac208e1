"""AST invariant linter for the port's storage planes
(``repro_torch.core`` + ``repro_torch.serve``).

The store's correctness arguments are concurrency contracts that unit
tests exercise but cannot *enforce* — a regression only shows up as a
rare lost update or a deadlock under load.  This module walks the ASTs
and checks the contracts structurally:

**(a) accounting** — :class:`Fabric` counters are caller-thread-owned:
no function reachable from an executor-``submit`` root may mutate one,
and thread roots (daemon loops) may only touch the counters a single
daemon owns (``DAEMON_OWNED_COUNTERS``).

**(b) lock-guard** — attributes a class registers in its
``_GUARDED_BY`` dict may only be read or written inside a lexical
``with <base>.<lock>:`` over the registered lock.

**(c) lock-blocking** — no ``time.sleep``, fabric transfer
(``_client_xfer``), replication hop (``_hop_put``), retry loop, or OSD
RPC inside a body holding any discovered ``threading.Lock``.

**(d) write-path** — every function that rewrites OSD blob/xattr state
must reach cache invalidation in its call closure, and every user of
``_next_version`` must reach both ``content_digest`` stamping and
invalidation (the version/digest/cache triple moves together).

The call graph is intentionally an under-approximation: calls on
receivers whose type cannot be resolved from ``VAR_TYPES``/``self``
are ignored rather than guessed, and only one level of
callable-parameter passthrough is followed (``f(cb)`` where ``f``
submits its parameter).  That keeps findings precise — each one names
a concrete root-to-mutation path — at the cost of not *proving*
absence; the dynamic half (``repro_torch.analysis.lockcheck``) covers the
runtime side.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from repro_torch.analysis.base import Finding

# --------------------------------------------------------------------------
# resolution tables (the repo's naming conventions, made explicit)
# --------------------------------------------------------------------------

# variable/attribute name -> class, for receiver typing.  These are the
# repo's stable idioms; an unresolved receiver is *skipped*, so a wrong
# entry here produces false findings, not silence — keep it short.
VAR_TYPES: dict[str, str] = {
    "osd": "OSD",
    "entry": "OSD",
    "store": "ObjectStore",
    "cache": "ResultCache",
    "session": "ScanSession",
    "maintenance": "MaintenancePlane",
    "w": "SkyhookWorker",
}

# attribute names whose subscript yields an OSD (``self.osds[osd_id]``)
OSD_MAPS = frozenset({"osds"})
# method names returning an OSD (``self._osd(osd_id)``)
OSD_GETTERS = frozenset({"_osd"})

# Fabric counters a maintenance daemon owns exclusively (exactly one
# writer thread each) — the only counters a thread root may reach.
DAEMON_OWNED_COUNTERS = frozenset({
    "scrub_bytes", "corruptions_detected", "heals", "recovery_bytes",
    "compactions", "compaction_bytes", "rebalance_bytes",
    "gc_objects", "gc_bytes",
})

# pass (c): calls that block, by shape
BLOCKING_ATTRS = frozenset({"_client_xfer", "_hop_put", "_replicate",
                            "_osd_call", "_osd_call_quiet"})
OSD_RPCS = frozenset({"get", "put", "put_batch", "exec_cls",
                      "exec_cls_batch", "compact_merge", "stat",
                      "get_xattrs", "list_xattrs"})

# pass (d): blob/xattr stores and the invalidation/stamping calls
OSD_STATE_ATTRS = frozenset({"data", "xattrs"})
INVALIDATORS = frozenset({"invalidate", "invalidate_cached"})
DIGEST_FNS = frozenset({"content_digest"})

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


# --------------------------------------------------------------------------
# index: functions, classes, locks, guards
# --------------------------------------------------------------------------


class FuncInfo:
    """One function/method/nested-def/lambda and its analysis scope."""

    def __init__(self, node, qualname: str, file: str, module: str,
                 cls_name: str | None, parent: "FuncInfo | None"):
        self.node = node
        self.qualname = qualname
        self.file = file
        self.module = module
        self.cls_name = cls_name      # owning class for methods, else the
        #                               enclosing method's class for nested
        self.parent = parent
        self.children: dict[str, FuncInfo] = {}
        self.lambdas: dict[int, FuncInfo] = {}   # id(node) -> info

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    def scope(self) -> Iterator[ast.AST]:
        """All descendant nodes, not descending into nested defs (their
        bodies are separate :class:`FuncInfo` scopes)."""
        todo = list(ast.iter_child_nodes(self.node))
        while todo:
            n = todo.pop()
            yield n
            if not isinstance(n, _SCOPE_NODES):
                todo.extend(ast.iter_child_nodes(n))

    def __repr__(self):
        return f"<func {self.qualname}>"


class ClassInfo:
    def __init__(self, name: str, file: str):
        self.name = name
        self.file = file
        self.methods: dict[str, FuncInfo] = {}
        self.guarded: dict[str, str] = {}   # attr -> lock attr
        self.locks: set[str] = set()        # threading.Lock() attrs


class Codebase:
    """Parsed view of the checked packages, plus the call graph."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.functions: list[FuncInfo] = []
        self.classes: dict[str, ClassInfo] = {}
        self.module_funcs: dict[str, dict[str, FuncInfo]] = {}
        self.fabric_counters: set[str] = set()
        for rel in ("src/repro_torch/core", "src/repro_torch/serve"):
            d = self.root / rel
            for path in sorted(d.glob("*.py")):
                self._index_module(path)
        self._edges: dict[int, set[FuncInfo]] = {}   # id(F) -> targets
        # (func, param name) pairs whose value gets pool-submitted
        self.submit_params: set[tuple[FuncInfo, str]] = set()

    # ------------------------------------------------------------ indexing
    def _index_module(self, path: Path) -> None:
        rel = str(path.relative_to(self.root))
        module = path.stem
        tree = ast.parse(path.read_text(), filename=rel)
        self.module_funcs.setdefault(module, {})
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = self._add_func(stmt, stmt.name, rel, module,
                                   None, None)
                self.module_funcs[module][stmt.name] = f
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(stmt, rel, module)

    def _index_class(self, node: ast.ClassDef, rel: str,
                     module: str) -> None:
        ci = self.classes.setdefault(node.name, ClassInfo(node.name, rel))
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = self._add_func(stmt, f"{node.name}.{stmt.name}",
                                   rel, module, node.name, None)
                ci.methods[stmt.name] = f
                if stmt.name == "__init__":
                    self._scan_init_locks(ci, f)
            elif isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if (isinstance(tgt, ast.Name)
                            and tgt.id == "_GUARDED_BY"
                            and isinstance(stmt.value, ast.Dict)):
                        for k, v in zip(stmt.value.keys,
                                        stmt.value.values):
                            if (isinstance(k, ast.Constant)
                                    and isinstance(v, ast.Constant)):
                                ci.guarded[k.value] = v.value
        if node.name == "Fabric":
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    self.fabric_counters.add(stmt.target.id)

    def _scan_init_locks(self, ci: ClassInfo, init: FuncInfo) -> None:
        """``self.X = threading.Lock()`` in ``__init__`` registers X as
        a lock attribute of the class (pass-c discovery)."""
        for n in init.scope():
            if not isinstance(n, ast.Assign):
                continue
            v = n.value
            is_lock = (isinstance(v, ast.Call)
                       and isinstance(v.func, ast.Attribute)
                       and v.func.attr in ("Lock", "RLock")
                       and isinstance(v.func.value, ast.Name)
                       and v.func.value.id == "threading")
            if not is_lock:
                continue
            for tgt in n.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    ci.locks.add(tgt.attr)

    def _add_func(self, node, qualname: str, rel: str, module: str,
                  cls_name: str | None,
                  parent: FuncInfo | None) -> FuncInfo:
        f = FuncInfo(node, qualname, rel, module, cls_name, parent)
        self.functions.append(f)
        # register nested defs and lambdas as child scopes
        for n in f.scope():
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child = self._add_func(n, f"{qualname}.{n.name}", rel,
                                       module, cls_name, f)
                f.children[n.name] = child
            elif isinstance(n, ast.Lambda):
                child = self._add_func(n, f"{qualname}.<lambda>", rel,
                                       module, cls_name, f)
                f.lambdas[id(n)] = child
        return f

    # ------------------------------------------------------------ typing
    def type_of(self, node: ast.AST, func: FuncInfo) -> str | None:
        """The class name of an expression's value, or None.  Resolves
        the repo's idioms only — anything else is *unknown*, never
        guessed."""
        if isinstance(node, ast.Name):
            if node.id == "self" and func.cls_name:
                return func.cls_name
            return VAR_TYPES.get(node.id)
        if isinstance(node, ast.Attribute):
            return VAR_TYPES.get(node.attr)
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Attribute) and base.attr in OSD_MAPS:
                return "OSD"
            if isinstance(base, ast.Name) and base.id in OSD_MAPS:
                return "OSD"
            return None
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in OSD_GETTERS:
                return "OSD"
            if isinstance(fn, ast.Name) and fn.id in self.classes:
                return fn.id       # constructor call
            return None
        return None

    def resolve(self, node: ast.AST,
                func: FuncInfo) -> FuncInfo | None:
        """The FuncInfo a callable expression refers to, or None."""
        if isinstance(node, ast.Lambda):
            g: FuncInfo | None = func
            while g is not None:
                if id(node) in g.lambdas:
                    return g.lambdas[id(node)]
                g = g.parent
            return None
        if isinstance(node, ast.Name):
            g = func
            while g is not None:
                if node.id in g.children:
                    return g.children[node.id]
                g = g.parent
            return self.module_funcs.get(func.module, {}).get(node.id)
        if isinstance(node, ast.Attribute):
            t = self.type_of(node.value, func)
            if t in self.classes:
                return self.classes[t].methods.get(node.attr)
        return None

    # ------------------------------------------------------------ call graph
    def edges(self, func: FuncInfo) -> set[FuncInfo]:
        """Direct callees of ``func``: call targets plus any resolvable
        function reference passed as a call argument (callback
        capture — a captured callable is assumed to run on the
        capturing side's thread)."""
        cached = self._edges.get(id(func))
        if cached is not None:
            return cached
        out: set[FuncInfo] = set()
        for n in func.scope():
            if not isinstance(n, ast.Call):
                continue
            tgt = self.resolve(n.func, func)
            if tgt is not None:
                out.add(tgt)
            for a in list(n.args) + [k.value for k in n.keywords]:
                cb = self.resolve(a, func)
                if cb is not None:
                    out.add(cb)
        self._edges[id(func)] = out
        return out

    def closure(self, root: FuncInfo) -> set[FuncInfo]:
        seen = {root}
        todo = [root]
        while todo:
            f = todo.pop()
            for g in self.edges(f):
                if g not in seen:
                    seen.add(g)
                    todo.append(g)
        return seen

    # ------------------------------------------------------------ guards
    def guard_for(self, cls: str | None,
                  attr: str) -> str | None:
        if cls is None:
            return None
        ci = self.classes.get(cls)
        return ci.guarded.get(attr) if ci else None

    def all_lock_attrs(self) -> set[str]:
        out: set[str] = set()
        for ci in self.classes.values():
            out |= ci.locks
        return out


# --------------------------------------------------------------------------
# pass (a): accounting discipline
# --------------------------------------------------------------------------


def _fabric_mutations(cb: Codebase,
                      f: FuncInfo) -> list[tuple[str, int]]:
    """``(counter, line)`` for each Fabric-counter mutation in ``f``.

    A mutation is an (Aug)Assign whose target is ``<fabric>.<counter>``
    where ``<fabric>`` is an attribute named ``fabric``, a local alias
    assigned from one, or ``self`` inside the Fabric class itself.
    """
    aliases: set[str] = set()
    for n in f.scope():
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "fabric"):
            aliases.add(n.targets[0].id)

    def is_fabric(base: ast.AST) -> bool:
        if isinstance(base, ast.Attribute) and base.attr == "fabric":
            return True
        if isinstance(base, ast.Name):
            if base.id in aliases:
                return True
            if base.id == "self" and f.cls_name == "Fabric":
                return True
        return False

    out: list[tuple[str, int]] = []
    for n in f.scope():
        targets: list[ast.AST] = []
        if isinstance(n, ast.AugAssign):
            targets = [n.target]
        elif isinstance(n, ast.Assign):
            targets = list(n.targets)
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and t.attr in cb.fabric_counters
                    and is_fabric(t.value)):
                out.append((t.attr, t.lineno))
    return out


def _collect_roots(cb: Codebase) -> dict[FuncInfo, set[str]]:
    """Off-caller-thread entry points: functions handed to an executor
    (``kind="submit"``) or to ``threading.Thread`` (``kind="thread"``).

    Thread-creating functions also contribute every ``self.<method>``
    reference they make (daemon loops receive their step functions via
    data structures — ``steps = {"scrub": self.scrub_step, ...}`` —
    which a pure call-walk would miss).
    """
    roots: dict[FuncInfo, set[str]] = {}

    def add(f: FuncInfo | None, kind: str) -> None:
        if f is not None:
            roots.setdefault(f, set()).add(kind)

    for f in cb.functions:
        makes_thread = False
        for n in f.scope():
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            if isinstance(fn, ast.Attribute) and fn.attr == "submit":
                if n.args:
                    a0 = n.args[0]
                    add(cb.resolve(a0, f), "submit")
                    if (isinstance(a0, ast.Name)
                            and cb.resolve(a0, f) is None):
                        cb.submit_params.add((f, a0.id))
            is_thread_ctor = (
                (isinstance(fn, ast.Attribute) and fn.attr == "Thread")
                or (isinstance(fn, ast.Name) and fn.id == "Thread"))
            if is_thread_ctor:
                makes_thread = True
                for k in n.keywords:
                    if k.arg == "target":
                        add(cb.resolve(k.value, f), "thread")
        if makes_thread and f.cls_name:
            ci = cb.classes.get(f.cls_name)
            for n in f.scope():
                if (isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self" and ci
                        and n.attr in ci.methods):
                    add(ci.methods[n.attr], "thread")

    # one level of callable-parameter passthrough: if g submits its
    # parameter p, every resolvable argument bound to p at a call site
    # of g is itself a submit root
    if cb.submit_params:
        by_func: dict[int, tuple[FuncInfo, set[str]]] = {}
        for g, pname in cb.submit_params:
            by_func.setdefault(id(g), (g, set()))[1].add(pname)
        for f in cb.functions:
            for n in f.scope():
                if not isinstance(n, ast.Call):
                    continue
                g = cb.resolve(n.func, f)
                if g is None or id(g) not in by_func:
                    continue
                _, pnames = by_func[id(g)]
                params = [a.arg for a in g.node.args.args]
                offset = 1 if (params and params[0] == "self"
                               and isinstance(n.func, ast.Attribute)) \
                    else 0
                for i, a in enumerate(n.args):
                    if i + offset < len(params) \
                            and params[i + offset] in pnames:
                        add(cb.resolve(a, f), "submit")
                for k in n.keywords:
                    if k.arg in pnames:
                        add(cb.resolve(k.value, f), "submit")
    return roots


def check_accounting(cb: Codebase) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, str, str, str]] = set()
    for root, kinds in _collect_roots(cb).items():
        cl = cb.closure(root)
        for kind in sorted(kinds):
            for f in cl:
                for counter, line in _fabric_mutations(cb, f):
                    if kind == "thread" \
                            and counter in DAEMON_OWNED_COUNTERS:
                        continue
                    k = (root.qualname, f.qualname, counter, kind)
                    if k in seen:
                        continue
                    seen.add(k)
                    findings.append(Finding(
                        "accounting", root.file, root.line,
                        root.qualname,
                        f"Fabric.{counter} mutated at {f.file}:{line} "
                        f"({f.qualname}), reachable from this "
                        f"{kind} root — counters are caller-thread-"
                        f"owned"))
    return findings


# --------------------------------------------------------------------------
# passes (b) + (c): lock discipline / blocking while locked
# --------------------------------------------------------------------------


def _walk_with_locks(cb: Codebase, f: FuncInfo):
    """Yield ``(node, held)`` for every node in ``f``'s scope, where
    ``held`` is the frozenset of lock expressions (unparsed, e.g.
    ``"osd.lock"``) lexically held at that node."""
    lock_attrs = cb.all_lock_attrs()

    def rec(children, held: frozenset[str]):
        for child in children:
            if isinstance(child, _SCOPE_NODES):
                continue
            yield child, held
            if isinstance(child, ast.With):
                inner = set(held)
                for item in child.items:
                    e = item.context_expr
                    if (isinstance(e, ast.Attribute)
                            and e.attr in lock_attrs):
                        inner.add(ast.unparse(e))
                    # the with-items themselves evaluate unlocked
                    yield from rec(ast.iter_child_nodes(item), held)
                yield from rec(child.body, frozenset(inner))
            else:
                yield from rec(ast.iter_child_nodes(child), held)

    yield from rec(ast.iter_child_nodes(f.node), frozenset())


def check_lock_guard(cb: Codebase) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for f in cb.functions:
        for node, held in _walk_with_locks(cb, f):
            if not isinstance(node, ast.Attribute):
                continue
            t = cb.type_of(node.value, f)
            lock = cb.guard_for(t, node.attr)
            if lock is None:
                continue
            if (f.name == "__init__" and f.cls_name == t
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                continue    # construction happens-before sharing
            needed = f"{ast.unparse(node.value)}.{lock}"
            if needed in held:
                continue
            k = (f.qualname, node.attr)
            if k in seen:
                continue
            seen.add(k)
            findings.append(Finding(
                "lock-guard", f.file, node.lineno, f.qualname,
                f"{t}.{node.attr} accessed without holding "
                f"{needed} (declared in {t}._GUARDED_BY)"))
    return findings


def check_lock_blocking(cb: Codebase) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for f in cb.functions:
        for node, held in _walk_with_locks(cb, f):
            if not held or not isinstance(node, ast.Call):
                continue
            fn = node.func
            what = None
            if isinstance(fn, ast.Attribute):
                if (fn.attr == "sleep"
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "time"):
                    what = "time.sleep"
                elif fn.attr in BLOCKING_ATTRS:
                    what = fn.attr
                elif (fn.attr in OSD_RPCS
                      and cb.type_of(fn.value, f) == "OSD"):
                    what = f"OSD.{fn.attr} RPC"
            if what is None:
                continue
            k = (f.qualname, what)
            if k in seen:
                continue
            seen.add(k)
            findings.append(Finding(
                "lock-blocking", f.file, node.lineno, f.qualname,
                f"{what} called while holding "
                f"{', '.join(sorted(held))}"))
    return findings


# --------------------------------------------------------------------------
# pass (d): write-path completeness
# --------------------------------------------------------------------------


def _writes_osd_state(cb: Codebase, f: FuncInfo) -> int | None:
    """Line of the first blob/xattr rewrite in ``f``, or None."""

    def osd_state(node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and node.attr in OSD_STATE_ATTRS
                and cb.type_of(node.value, f) == "OSD")

    for n in f.scope():
        targets: list[ast.AST] = []
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) \
                else [n.target]
        elif isinstance(n, ast.Delete):
            targets = list(n.targets)
        for t in targets:
            if isinstance(t, ast.Subscript) and osd_state(t.value):
                return t.lineno
        if (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("pop", "clear", "update")
                and osd_state(n.func.value)):
            return n.lineno
    return None


def _closure_calls(cb: Codebase, root: FuncInfo,
                   names: frozenset[str]) -> bool:
    """Does any function in ``root``'s call closure call one of
    ``names`` (matched by bare name or attribute name)?"""
    for f in cb.closure(root):
        for n in f.scope():
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            if isinstance(fn, ast.Name) and fn.id in names:
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in names:
                return True
    return False


def check_write_path(cb: Codebase) -> list[Finding]:
    findings: list[Finding] = []
    for f in cb.functions:
        if f.name == "__init__":
            continue
        # (d1) raw blob/xattr rewrite must reach invalidation
        line = _writes_osd_state(cb, f)
        if line is not None \
                and not _closure_calls(cb, f, INVALIDATORS):
            findings.append(Finding(
                "write-path", f.file, line, f.qualname,
                "rewrites OSD blob/xattr state but never reaches "
                "cache invalidation (invalidate/invalidate_cached) "
                "in its call closure"))
        # (d2) version allocation must reach digest stamping AND
        # invalidation — the version/digest/cache triple is atomic
        calls_next_version = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "_next_version"
            for n in f.scope())
        if not calls_next_version or f.name == "_next_version":
            continue
        missing = []
        if not _closure_calls(cb, f, DIGEST_FNS):
            missing.append("content_digest stamping")
        if not _closure_calls(cb, f, INVALIDATORS):
            missing.append("cache invalidation")
        if missing:
            findings.append(Finding(
                "write-path", f.file, f.line, f.qualname,
                f"allocates a version (_next_version) but its call "
                f"closure never reaches {' or '.join(missing)}"))
    return findings


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def analyze(root: Path) -> list[Finding]:
    """Run all AST passes over the repo rooted at ``root``."""
    cb = Codebase(root)
    findings: list[Finding] = []
    findings += check_accounting(cb)
    findings += check_lock_guard(cb)
    findings += check_lock_blocking(cb)
    findings += check_write_path(cb)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
