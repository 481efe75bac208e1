"""Dynamic lock-order / lock-ownership checker — the runtime half of
the verification plane.

:func:`install` monkey-patches the ``__init__`` of every class in the
core concurrency modules so that, after construction:

* every ``threading.Lock`` attribute is replaced by an
  :class:`InstrumentedLock` that records, per thread, the stack of
  held locks and feeds a global **lock-order graph** (edge
  ``A -> B`` = some thread acquired B while holding A, keyed by
  ``Class.attr`` so instances aggregate);
* every *container* attribute registered in the class's
  ``_GUARDED_BY`` dict is wrapped in a guarded proxy whose **mutator**
  operations record a violation when the owning lock is not held by
  the calling thread (reads by quiescent observers — tests peeking at
  counters — are deliberately not flagged; the static pass covers
  read discipline lexically).

A cycle in the order graph (including a ``Class.attr`` self-edge:
two *instances* of the same lock held at once) is a deadlock hazard
even if no deadlock happened in this run — that is the point: the
harness turns "it didn't hang today" into "no inconsistent order was
ever exhibited".  The pytest ``--lockcheck-torch`` flag (the plugin
``repro_torch.analysis.pytest_plugin``) installs this over the whole
suite and fails the run on any cycle or ownership violation.
"""

from __future__ import annotations

import threading
import traceback
from collections import OrderedDict
from typing import Any

_LOCK_TYPE = type(threading.Lock())


class LockCheckState:
    """Global recording state shared by every instrumented lock."""

    def __init__(self) -> None:
        self._mx = threading.Lock()        # guards the state itself
        self._held = threading.local()     # per-thread list of locks
        self.edges: dict[str, set[str]] = {}
        self.edge_sites: dict[tuple[str, str], str] = {}
        self.violations: OrderedDict[tuple[str, str], str] = \
            OrderedDict()
        self.acquisitions = 0
        self.wrapped_locks = 0
        self.wrapped_containers = 0

    # ------------------------------------------------------------ held
    def _stack(self) -> list:
        st = getattr(self._held, "locks", None)
        if st is None:
            st = self._held.locks = []
        return st

    def holds(self, lock: "InstrumentedLock") -> bool:
        return any(h is lock for h in self._stack())

    # ------------------------------------------------------------ events
    def note_acquire(self, lock: "InstrumentedLock") -> None:
        st = self._stack()
        if st:
            site = _caller()
            with self._mx:
                for held in st:
                    # A -> A on the SAME instance would be a
                    # self-deadlock and cannot reach here (acquire
                    # would block); same NAME on another instance is
                    # a real ordering hazard and is recorded.
                    if held is lock:
                        continue
                    e = (held.name, lock.name)
                    self.edges.setdefault(e[0], set()).add(e[1])
                    self.edge_sites.setdefault(e, site)
        with self._mx:
            self.acquisitions += 1
        st.append(lock)

    def note_release(self, lock: "InstrumentedLock") -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock:
                del st[i]
                return

    def note_violation(self, what: str, op: str) -> None:
        site = _caller()
        with self._mx:
            self.violations.setdefault(
                (what, site), f"{what}.{op} without owning lock "
                              f"at {site}")

    # ------------------------------------------------------------ verdict
    def cycles(self) -> list[list[str]]:
        """Elementary ordering cycles in the lock-order graph (Tarjan
        SCCs; a single-node SCC counts when it has a self-edge)."""
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on: set[str] = set()
        stack: list[str] = []
        out: list[list[str]] = []
        counter = [0]

        def strong(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            for w in self.edges.get(v, ()):
                if w not in index:
                    strong(w)
                    low[v] = min(low[v], low[w])
                elif w in on:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1 or v in self.edges.get(v, ()):
                    out.append(sorted(scc))

        for v in list(self.edges):
            if v not in index:
                strong(v)
        return out

    def report(self) -> dict:
        cyc = self.cycles()
        return {
            "acquisitions": self.acquisitions,
            "locks_instrumented": self.wrapped_locks,
            "containers_instrumented": self.wrapped_containers,
            "order_edges": {a: sorted(bs)
                            for a, bs in sorted(self.edges.items())},
            "cycles": cyc,
            "violations": list(self.violations.values()),
            "ok": not cyc and not self.violations,
        }


def _caller() -> str:
    """First stack frame outside this module (the code under test)."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if "analysis/lockcheck" not in frame.filename.replace(
                "\\", "/"):
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


class InstrumentedLock:
    """Drop-in ``threading.Lock`` recording order + ownership."""

    __slots__ = ("name", "_lk", "_state")

    def __init__(self, name: str, state: LockCheckState):
        self.name = name
        self._lk = threading.Lock()
        self._state = state

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        got = self._lk.acquire(blocking, timeout)
        if got:
            self._state.note_acquire(self)
        return got

    def release(self) -> None:
        self._state.note_release(self)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name}>"


# --------------------------------------------------------------------------
# guarded-container proxies: mutators must hold the owning lock
# --------------------------------------------------------------------------


def _mutator(name: str):
    def op(self, *a, **k):
        # no state yet: the proxy is being filled from the container it
        # wraps (OrderedDict's constructor goes through __setitem__)
        state = getattr(self, "_lc_state", None)
        if state is not None and not state.holds(self._lc_owner):
            state.note_violation(self._lc_name, name)
        return getattr(self._lc_base, name)(self, *a, **k)
    op.__name__ = name
    return op


def _make_guarded(base: type) -> type:
    muts = {
        dict: ("__setitem__", "__delitem__", "pop", "popitem",
               "setdefault", "update", "clear"),
        OrderedDict: ("__setitem__", "__delitem__", "pop", "popitem",
                      "setdefault", "update", "clear", "move_to_end"),
        set: ("add", "discard", "remove", "pop", "clear", "update",
              "difference_update", "intersection_update"),
    }[base]
    ns: dict[str, Any] = {"_lc_base": base,
                          "__slots__": ("_lc_owner", "_lc_state",
                                        "_lc_name")}
    for m in muts:
        ns[m] = _mutator(m)
    ns["__reduce_ex__"] = _plain_reduce
    return type(f"Guarded{base.__name__}", (base,), ns)


def _plain_reduce(self, protocol):
    """A copy (``copy.copy``, ``copy.deepcopy``, pickle) of a guarded
    container is a plain container of its base type: a snapshot owns no
    lock, and the owning lock itself cannot be copied."""
    return self._lc_base, (self._lc_base(self),)


GuardedDict = _make_guarded(dict)
GuardedOrderedDict = _make_guarded(OrderedDict)
GuardedSet = _make_guarded(set)

_PROXIES: dict[type, type] = {dict: GuardedDict,
                              OrderedDict: GuardedOrderedDict,
                              set: GuardedSet}


def _wrap_container(value, name: str, owner: InstrumentedLock,
                    state: LockCheckState):
    proxy = _PROXIES.get(type(value))
    if proxy is None:
        return None
    wrapped = proxy(value)
    wrapped._lc_owner = owner
    wrapped._lc_state = state
    wrapped._lc_name = name
    return wrapped


# --------------------------------------------------------------------------
# install / uninstall
# --------------------------------------------------------------------------

_CORE_MODULES = ("repro_torch.core.store", "repro_torch.core.cache",
                 "repro_torch.core.session", "repro_torch.core.maintenance",
                 "repro_torch.core.faults", "repro_torch.core.skyhook")


def _instrument_instance(self, state: LockCheckState) -> None:
    cls = type(self)
    try:
        attrs = vars(self)
    except TypeError:       # __slots__-only instances hold no locks
        return
    locks: dict[str, InstrumentedLock] = {}
    for attr, value in list(attrs.items()):
        if isinstance(value, _LOCK_TYPE):
            il = InstrumentedLock(f"{cls.__name__}.{attr}", state)
            setattr(self, attr, il)
            locks[attr] = il
            state.wrapped_locks += 1
    guarded = getattr(cls, "_GUARDED_BY", None)
    if not guarded:
        return
    for attr, lock_attr in guarded.items():
        owner = locks.get(lock_attr)
        value = attrs.get(attr)
        if owner is None or value is None:
            continue
        wrapped = _wrap_container(value, f"{cls.__name__}.{attr}",
                                  owner, state)
        if wrapped is not None:
            setattr(self, attr, wrapped)
            state.wrapped_containers += 1


def install() -> LockCheckState:
    """Patch the core classes; returns the recording state.  Call
    :func:`uninstall` to undo (idempotent per install)."""
    import importlib

    state = LockCheckState()
    patched: list[tuple[type, Any]] = []
    for modname in _CORE_MODULES:
        mod = importlib.import_module(modname)
        for obj in list(vars(mod).values()):
            if not isinstance(obj, type) \
                    or obj.__module__ != modname:
                continue
            orig = obj.__init__

            def make(orig_init):
                def patched_init(self, *a, **k):
                    orig_init(self, *a, **k)
                    _instrument_instance(self, state)
                patched_init.__wrapped__ = orig_init
                return patched_init

            obj.__init__ = make(orig)
            patched.append((obj, orig))
    state._patched = patched        # type: ignore[attr-defined]
    return state


def uninstall(state: LockCheckState) -> None:
    for cls, orig in getattr(state, "_patched", ()):
        cls.__init__ = orig
    state._patched = []             # type: ignore[attr-defined]
