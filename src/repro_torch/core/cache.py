"""Byte-bounded LRU result cache — the OSD half of the hot-data serve
plane.

Each :class:`~repro_torch.core.store.OSD` owns one :class:`ResultCache`
holding decoded column tables and per-object pipeline results keyed by
``(object name, xattr version, pipeline/columns digest)``.  The
monotonic ``version`` stamped by every write path gives exact
invalidation for free: a write, heal, or compaction bumps the version,
so stale entries simply never match a current lookup — eviction is a
memory concern, never a correctness one.  Entries are derived from
digest-verified blobs at insert time and are dropped eagerly on
anything that pulls the source copy out of service (rewrite,
quarantine, delete), so a cached result is never served across a
version bump.

Thread-safety: all mutators run under one internal lock (OSD serve
paths run concurrently on the store's pool workers).  The cache never
touches ``Fabric`` counters itself — per-request hit/miss/eviction
deltas ride back in the batched response and are accumulated by the
client thread that issued the call, preserving the store's
single-accounting-thread counter contract.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable

_MISS = object()


class Negative:
    """A cached *negative* result: the object provably served NOTHING
    for this key — missing from the store, disjoint from a resolved
    row/hyperslab range, or zone-map pruned.  Cached under the same
    ``(name, version, ...)`` keyed scheme as positive entries (so the
    version-bump and eager-invalidation paths retire them identically),
    it lets a repeat scan skip digest verification, op resolution, and
    the service queue for objects that still have nothing to say.
    ``reason`` is the disposition the original miss reported
    ("missing" / "skipped" / "pruned") so the replay answers with the
    same shape."""

    __slots__ = ("reason",)
    NBYTES = 64  # accounting charge per negative entry (tiny, not free)

    def __init__(self, reason: str):
        self.reason = reason

    def __repr__(self):
        return f"Negative({self.reason!r})"


class ResultCache:
    """LRU mapping ``key -> value`` bounded by total payload bytes.

    Keys are tuples whose FIRST element is the object name — the
    per-name index built from it makes ``invalidate(name)`` O(entries
    for that name), which is what the write/quarantine paths call on
    every version bump.  ``capacity <= 0`` disables the cache entirely
    (every ``get`` misses, every ``put`` is a no-op) so a cold store
    pays nothing for the feature.
    """

    # lock-discipline contract: the entry map, the per-name index, and
    # the byte gauge move together — partial views are never visible
    # outside ``_lock``
    _GUARDED_BY = {"_entries": "_lock", "_by_name": "_lock",
                   "_bytes": "_lock"}

    def __init__(self, capacity_bytes: int = 0):
        self.capacity = int(capacity_bytes or 0)
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, tuple[Any, int]] = \
            OrderedDict()
        self._by_name: dict[str, set[Hashable]] = {}
        self._bytes = 0

    # ------------------------------------------------------------ lookup
    def get(self, key: Hashable) -> Any:
        """The cached value (refreshed to MRU) or the module-level
        ``_MISS`` sentinel — values themselves may be any object."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return _MISS
            self._entries.move_to_end(key)
            return ent[0]

    # ------------------------------------------------------------ insert
    def put(self, key: Hashable, value: Any,
            nbytes: int) -> tuple[int, int]:
        """Insert (or refresh) one entry, evicting LRU entries until the
        byte bound holds again.  Returns ``(evicted_entries,
        inserted_bytes)`` for the caller's per-request meters — an
        over-capacity value is refused (0 inserted) rather than allowed
        to flush the whole cache for one unreusable result."""
        nbytes = int(nbytes)
        if self.capacity <= 0 or nbytes > self.capacity:
            return 0, 0
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._by_name[key[0]].discard(key)
            while self._bytes + nbytes > self.capacity and self._entries:
                self._evict_lru()
                evicted += 1
            self._entries[key] = (value, nbytes)
            self._by_name.setdefault(key[0], set()).add(key)
            self._bytes += nbytes
        return evicted, nbytes

    def _evict_lru(self) -> None:
        key, (_, nb) = self._entries.popitem(last=False)
        self._bytes -= nb
        keys = self._by_name.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_name[key[0]]

    def put_negative(self, key: Hashable, reason: str) -> tuple[int, int]:
        """Cache a nothing-to-serve disposition (see :class:`Negative`)."""
        return self.put(key, Negative(reason), Negative.NBYTES)

    # ------------------------------------------------------------ drop
    def invalidate(self, name: str) -> int:
        """Drop every entry for one object name (called on rewrite,
        quarantine, and delete).  Returns the entry count dropped."""
        with self._lock:
            keys = self._by_name.pop(name, None)
            if not keys:
                return 0
            for key in keys:
                _, nb = self._entries.pop(key)
                self._bytes -= nb
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_name.clear()
            self._bytes = 0

    # ------------------------------------------------------------ observe
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries_for(self, name: str) -> int:
        with self._lock:
            return len(self._by_name.get(name, ()))
