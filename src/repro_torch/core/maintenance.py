"""Online maintenance plane: the background services a long-lived
cluster needs to stay healthy WHILE the serve plane keeps answering —
the other half of ROADMAP item 2, and the paper's claim that mapping
datasets onto an extensible object store lets access libraries lean on
the store's own "load balancing, elasticity, and failure management"
instead of reimplementing them per format.

:class:`MaintenancePlane` owns four long-lived daemon workers over one
:class:`~repro_torch.core.store.ObjectStore`:

* **continuous scrub walker** — incrementally walks every OSD's
  inventory in small batches (``batch_objects`` per step), reusing the
  store's per-object classify/quarantine/heal step
  (``ObjectStore._scrub_object`` — the same logic as on-demand
  ``scrub()``) under a ``scrub_rate_bytes_s`` token bucket, so
  foreground ``queue_wait_s`` stays bounded.  The walk keys on a NAME
  cursor, not indices, so it survives ``fail_osd``/``add_osds`` churn
  mid-round: the inventory and acting sets are re-resolved every step.
* **small-object compactor** — folds runs of under-target neighbors
  (the one-blob-per-append ``ckpt``/kvcache pattern) into target-sized
  objects via the OSD-side ``compact_merge`` objclass op, then rewrites
  the dataset's ``.objmap`` with a version bump so compiled plans
  re-target through the existing ``_refresh`` path.  The replaced
  members are NOT deleted — they enter the versioned-GC ledger and stay
  servable until the retention window closes, so in-flight scans stay
  bit-exact.
* **live rebalancer** — after ``fail_osd``/``add_osds`` bumps the
  epoch, walks objects toward their CURRENT placement in digest-
  verified, rate-limited steps (``ObjectStore.rebalance_object``: the
  old copy is retained until every acting copy verifies), relying on
  OSD-resolved extents so compiled plans survive the move.
* **versioned GC** — reclaims dead versions (compaction leftovers) and
  quarantined copies once they have aged past the operator-confirmed
  ``gc_retention_s`` window.  It re-checks that a dead name is not
  referenced by the dataset's CURRENT map before collecting, and never
  purges a quarantined copy unless a digest-verified copy of that
  object survives elsewhere — the sole remaining copy, however
  suspect, is evidence, not garbage.

Counter ownership: each maintenance ``Fabric`` counter has ONE writer —
the daemon that owns that work (the walker owns ``scrub_bytes``/
``corruptions_detected``/``heals``, the compactor ``compactions``/
``compaction_bytes``, the rebalancer ``rebalance_bytes``, GC
``gc_objects``/``gc_bytes``) — preserving the store's accounting-thread
contract without cross-thread ``+=`` races.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core.partition import (
    ArrayObjectMap, PartitionPolicy, compact_plan, load_objmap,
    merge_run, objmap_key)
from repro_torch.core.store import DataLossError, ObjectStore, TokenBucket

_DAEMONS = ("scrub", "compact", "rebalance", "gc")

_OBJMAP_SUFFIX = "/.objmap"


class MaintenancePlane:
    """Background maintenance daemons for one store.  Construct, then
    ``start()`` — or drive the ``*_step`` methods synchronously (tests,
    operator one-shots).  ``pause()``/``resume()`` gate all daemons
    without losing cursors; ``stop()`` joins them.  Attaches itself as
    ``store.maintenance`` so topology changes wake the rebalancer and
    ``store.close()`` tears the plane down."""

    # lock-discipline contract: the ledger and the walk cursors are
    # shared between the daemons and client threads
    # (``note_topology_change`` fires from ``fail_osd``/``add_osds``),
    # so every access goes through ``_lock``
    _GUARDED_BY = {"_dead": "_lock", "_quar_seen": "_lock",
                   "_scrub_cursor": "_lock", "_rebal_cursor": "_lock",
                   "_compact_idx": "_lock"}

    def __init__(self, store: ObjectStore, *,
                 scrub_rate_bytes_s: float | None = None,
                 rebalance_rate_bytes_s: float | None = None,
                 compact_rate_bytes_s: float | None = None,
                 compact_policy: PartitionPolicy | None = None,
                 compact_datasets: list[str] | None = None,
                 gc_retention_s: float = 60.0,
                 gc_confirmed: bool = False,
                 batch_objects: int = 8,
                 interval_s: float = 0.001):
        self.store = store
        self.scrub_limiter = TokenBucket(scrub_rate_bytes_s)
        self.rebalance_limiter = TokenBucket(rebalance_rate_bytes_s)
        self.compact_limiter = TokenBucket(compact_rate_bytes_s)
        self.compact_policy = compact_policy or PartitionPolicy()
        self.compact_datasets = list(compact_datasets) \
            if compact_datasets is not None else None
        self.gc_retention_s = float(gc_retention_s)
        self.gc_confirmed = bool(gc_confirmed)
        self.batch_objects = max(1, int(batch_objects))
        self.interval_s = float(interval_s)

        # versioned-GC ledger: retired object name -> monotonic retire
        # time.  Entries are added by the compactor (replaced members,
        # aborted merge outputs) and collected by GC after retention.
        self._dead: dict[str, float] = {}
        # quarantined-copy ages: (name, osd_id) -> first-seen time
        self._quar_seen: dict[tuple[str, str], float] = {}
        self._lock = threading.Lock()

        # walk cursors (object NAMES — survive inventory churn)
        self._scrub_cursor = ""
        self._rebal_cursor = ""
        self._compact_idx = 0

        # observability (plane-local; Fabric holds the byte counters)
        self.scrub_objects = 0
        self.scrub_corrupt = 0
        self.scrub_healed = 0
        self.scrub_rounds = 0
        self.rebalance_rounds = 0
        self.compact_runs = 0
        self.gc_reclaimed = 0
        self.topology_changes = 0
        self.errors: list[tuple[str, str]] = []

        self._pause = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        store.maintenance = self

    # ------------------------------------------------------------ lifecycle
    def start(self, daemons: tuple[str, ...] = _DAEMONS
              ) -> "MaintenancePlane":
        """Spawn the requested daemons (all four by default).  Each
        loops its step at ``interval_s`` cadence while not paused."""
        if self._threads:
            raise RuntimeError("maintenance plane already started")
        self._stop.clear()
        steps = {"scrub": self.scrub_step, "compact": self.compact_step,
                 "rebalance": self.rebalance_step, "gc": self.gc_step}
        for d in daemons:
            if d not in steps:
                raise ValueError(f"unknown daemon {d!r}; "
                                 f"known: {_DAEMONS}")
            t = threading.Thread(target=self._loop, args=(d, steps[d]),
                                 name=f"maint-{d}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _loop(self, name: str, step) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                self._stop.wait(self.interval_s)
                continue
            try:
                step()
            except Exception as e:  # a sick step must not kill the
                with self._lock:    # daemon; record and keep walking
                    self.errors.append((name, repr(e)))
            self._stop.wait(self.interval_s)

    def pause(self) -> None:
        """Suspend all daemons after their current step.  Cursors and
        the GC ledger are kept — ``resume()`` continues mid-round, so a
        pause spanning ``fail_osd``/``add_osds`` churn costs nothing
        but time."""
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    @property
    def paused(self) -> bool:
        return self._pause.is_set()

    def stop(self) -> None:
        """Stop and join every daemon (idempotent)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        if self.store.maintenance is self:
            self.store.maintenance = None

    def note_topology_change(self) -> None:
        """Called by ``fail_osd``/``add_osds``: restart the rebalance
        walk from the top of the (new) inventory so every object gets
        re-examined against the fresh placement."""
        with self._lock:
            self._rebal_cursor = ""
            self.topology_changes += 1

    def confirm_gc(self) -> None:
        """Operator confirmation: versioned GC may reclaim entries that
        have aged past ``gc_retention_s``.  Without it ``gc_step`` only
        ages the ledger and never deletes."""
        self.gc_confirmed = True

    # ------------------------------------------------------------ inventory
    def _inventory(self) -> list[str]:
        """Current scrub-walk universe: every live object plus every
        quarantined name, minus the dead ledger (retired versions are
        read-only history awaiting GC — healing or re-replicating them
        would resurrect garbage)."""
        store = self.store
        names = set(store.list_objects()) | store._quarantined_names()
        with self._lock:
            names -= set(self._dead)
        return sorted(names)

    def _next_batch(self, names: list[str], cursor: str,
                    n: int) -> tuple[list[str], str, bool]:
        """The next ``n`` names after ``cursor`` — ``(batch, new_cursor,
        wrapped)``.  An exhausted cursor resets to the top and reports
        the wrap (one completed round)."""
        batch = [m for m in names if m > cursor][:n]
        if not batch:
            return [], "", bool(names)
        return batch, batch[-1], False

    # ------------------------------------------------------------ scrub
    def scrub_step(self) -> dict:
        """One walker increment: classify/quarantine/heal the next
        ``batch_objects`` names, paying verified bytes into the scrub
        rate limiter so a full-inventory round trickles instead of
        bursting."""
        names = self._inventory()
        with self._lock:
            cursor = self._scrub_cursor
        batch, cursor, wrapped = self._next_batch(
            names, cursor, self.batch_objects)
        with self._lock:
            self._scrub_cursor = cursor
        if wrapped:
            self.scrub_rounds += 1
        out = {"objects": 0, "corrupt": 0, "healed": 0}
        for name in batch:
            res = self.store._scrub_object(name, heal=True)
            self.scrub_limiter.consume(res["bytes"])
            out["objects"] += 1
            out["corrupt"] += res["corrupt"]
            out["healed"] += res["healed"]
        self.scrub_objects += out["objects"]
        self.scrub_corrupt += out["corrupt"]
        self.scrub_healed += out["healed"]
        return out

    # ------------------------------------------------------------ compact
    def _discover_datasets(self) -> list[str]:
        if self.compact_datasets is not None:
            return self.compact_datasets
        return [n[:-len(_OBJMAP_SUFFIX)]
                for n in self.store.list_objects()
                if n.endswith(_OBJMAP_SUFFIX)]

    def _objmap_blob(self, ds: str) -> tuple[bytes, int] | None:
        """The dataset's ``.objmap`` from its best local copy — no
        client fabric accounting; maintenance reads are cluster-
        internal."""
        verified, _, bare = self.store._verified_copies(objmap_key(ds))
        if verified:
            v, _, blob, _ = verified[0]
            return blob, int(v)
        if bare:
            _, blob, xattr = bare[0]
            return blob, int(xattr.get("version", -1))
        return None

    def _sizes(self, names: list[str]) -> dict[str, int]:
        """Stored size per object from the first up holder (OSD-local
        inspection).  Missing objects are absent from the result, which
        breaks compaction runs over them (mid-write or gone)."""
        store = self.store
        out: dict[str, int] = {}
        for name in names:
            for osd_id in store.cluster.up_osds:
                osd = store.osds[osd_id]
                with osd.lock:
                    blob = osd.data.get(name)
                if blob is not None:
                    out[name] = len(blob)
                    break
        return out

    def compact_step(self) -> dict | None:
        """One compaction increment: pick the next dataset round-robin,
        fold its FIRST under-target run into a fresh target-sized
        object (OSD-side ``compact_merge``), persist the rewritten map
        with a version bump (compiled plans re-target via ``_refresh``)
        and retire the replaced members into the GC ledger.  Returns
        what it did, or None when nothing needed compacting.

        Atomicity: the map rewrite is last, and only lands if the map's
        version is still the one the run was planned against — a racing
        metadata writer aborts the rewrite and the orphaned merge
        output goes straight to the GC ledger."""
        datasets = self._discover_datasets()
        if not datasets:
            return None
        for _ in range(len(datasets)):
            with self._lock:
                idx = self._compact_idx
                self._compact_idx = idx + 1
            ds = datasets[idx % len(datasets)]
            got = self._objmap_blob(ds)
            if got is None:
                continue
            blob, version = got
            omap = load_objmap(blob)
            if isinstance(omap, ArrayObjectMap):
                continue  # chunk granules are the access unit: skip
            with self._lock:
                dead = set(self._dead)
            live = [e.name for e in omap.extents if e.name not in dead]
            sizes = self._sizes(live)
            runs = compact_plan(omap, sizes, self.compact_policy)
            if not runs:
                continue
            start, stop = runs[0]
            members = [e.name for e in omap.extents[start:stop]]
            rows = (omap.extents[start].row_start,
                    omap.extents[stop - 1].row_stop)
            out_name = f"{ds}/cmp.{self.store._next_version():08d}"
            try:
                _, nbytes = self.store.compact_run(
                    members, out_name, rows=rows)
            except DataLossError:
                continue  # a member died mid-plan; scrub/heal first
            key = objmap_key(ds)
            cur = self._objmap_blob(ds)
            if cur is None or cur[1] != version:
                # the map moved under us: abort, GC the orphaned merge
                with self._lock:
                    self._dead[out_name] = time.monotonic()
                continue
            new_map = merge_run(omap, start, stop, out_name)
            _, moved = self.store._maint_put(key, new_map.to_bytes())
            self.compact_limiter.consume(nbytes + moved)
            now = time.monotonic()
            with self._lock:
                for m in members:
                    self._dead[m] = now
            self.compact_runs += 1
            return {"dataset": ds, "members": members,
                    "out": out_name, "bytes": nbytes}
        return None

    # ------------------------------------------------------------ rebalance
    def rebalance_step(self) -> dict:
        """One rebalance increment: nudge the next ``batch_objects``
        live objects toward their CURRENT acting sets (copy-verify-drop
        inside ``rebalance_object``), rate-limited by moved bytes."""
        names = [n for n in self._inventory() if self.store.exists(n)]
        with self._lock:
            start = self._rebal_cursor
        batch, cursor, wrapped = self._next_batch(
            names, start, self.batch_objects)
        if wrapped:
            self.rebalance_rounds += 1
        moved = 0
        for name in batch:
            nbytes = self.store.rebalance_object(name)
            self.rebalance_limiter.consume(nbytes)
            moved += nbytes
        with self._lock:
            if self._rebal_cursor == start:
                # advance only if no topology change reset the walk
                # mid-step — the reset must win, or churn during a
                # batch would skip the restart it asked for
                self._rebal_cursor = cursor
        return {"objects": len(batch), "bytes": moved}

    # ------------------------------------------------------------ gc
    def _referenced(self, name: str) -> bool:
        """Is ``name`` referenced by any dataset's CURRENT object map?
        The collect-time safety recheck: a retired name that came back
        into a live map (however unlikely) must never be deleted."""
        for ds in self._discover_datasets():
            got = self._objmap_blob(ds)
            if got is None:
                continue
            try:
                omap = load_objmap(got[0])
            except Exception:
                continue
            if name in omap.object_names():
                return True
        return False

    def gc_step(self) -> dict:
        """One GC sweep: reclaim dead-ledger entries and quarantined
        copies older than the retention window — only once the operator
        has confirmed (``confirm_gc``), and never the sole surviving
        copy of anything."""
        store = self.store
        now = time.monotonic()
        out = {"dead_reclaimed": 0, "quarantine_purged": 0, "bytes": 0}
        # age the quarantine ledger (first-seen timestamps)
        current: set[tuple[str, str]] = set()
        for osd_id in store.cluster.up_osds:
            osd = store.osds[osd_id]
            with osd.lock:
                quarantined = list(osd.quarantine)
            for name in quarantined:
                current.add((name, osd_id))
        with self._lock:
            for key in current:
                self._quar_seen.setdefault(key, now)
            for key in list(self._quar_seen):
                if key not in current:
                    del self._quar_seen[key]
        if not self.gc_confirmed:
            return out
        # dead versions past retention
        with self._lock:
            ripe = [n for n, t in self._dead.items()
                    if now - t >= self.gc_retention_s]
        for name in ripe:
            if self._referenced(name):
                with self._lock:
                    self._dead.pop(name, None)
                continue
            size = 0
            for osd_id in store.cluster.up_osds:
                osd = store.osds[osd_id]
                with osd.lock:
                    blob = osd.data.get(name)
                if blob is not None:
                    size += len(blob)
            store.delete(name)
            size += store.purge_quarantined(name)
            with self._lock:
                self._dead.pop(name, None)
            out["dead_reclaimed"] += 1
            out["bytes"] += size
            store.fabric.gc_objects += 1
            store.fabric.gc_bytes += size
        # quarantined copies of LIVE objects past retention — purge a
        # copy only when a digest-verified copy survives elsewhere
        with self._lock:
            quar_ripe = [k for k, t in self._quar_seen.items()
                         if now - t >= self.gc_retention_s]
        purged_names: set[str] = set()
        for name, _osd in quar_ripe:
            if name in purged_names:
                continue
            verified, _, _ = store._verified_copies(name)
            if not verified:
                continue  # sole remaining evidence: keep it
            freed = store.purge_quarantined(name)
            if freed:
                purged_names.add(name)
                out["quarantine_purged"] += 1
                out["bytes"] += freed
                store.fabric.gc_objects += 1
                store.fabric.gc_bytes += freed
        if purged_names:
            with self._lock:
                for key in list(self._quar_seen):
                    if key[0] in purged_names:
                        del self._quar_seen[key]
        self.gc_reclaimed += out["dead_reclaimed"] + \
            out["quarantine_purged"]
        return out

    # ------------------------------------------------------------ one-shots
    def run_once(self) -> dict:
        """One synchronous full pass of all four services (tests and
        operator one-shots): scrub the whole inventory, compact until
        no run remains, rebalance everything, then one GC sweep."""
        scrub = {"objects": 0, "corrupt": 0, "healed": 0}
        with self._lock:
            self._scrub_cursor = ""
        while True:
            got = self.scrub_step()
            if not got["objects"]:
                break
            for k in scrub:
                scrub[k] += got[k]
        compacted = []
        while True:
            got = self.compact_step()
            if got is None:
                break
            compacted.append(got)
        with self._lock:
            self._rebal_cursor = ""
        rebalanced = {"objects": 0, "bytes": 0}
        while True:
            got = self.rebalance_step()
            if not got["objects"]:
                break
            rebalanced["objects"] += got["objects"]
            rebalanced["bytes"] += got["bytes"]
        gc = self.gc_step()
        return {"scrub": scrub, "compacted": compacted,
                "rebalance": rebalanced, "gc": gc}

    # ------------------------------------------------------------ observe
    def stats(self) -> dict:
        with self._lock:
            return {
                "scrub_objects": self.scrub_objects,
                "scrub_corrupt": self.scrub_corrupt,
                "scrub_healed": self.scrub_healed,
                "scrub_rounds": self.scrub_rounds,
                "rebalance_rounds": self.rebalance_rounds,
                "compact_runs": self.compact_runs,
                "gc_reclaimed": self.gc_reclaimed,
                "dead_pending": len(self._dead),
                "topology_changes": self.topology_changes,
                "paused": self.paused,
                "gc_confirmed": self.gc_confirmed,
                "errors": list(self.errors),
            }
