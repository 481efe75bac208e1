"""RADOS-like distributed object store (simulated control plane).

OSDs are in-process shards with byte-accurate transfer accounting; the
semantics — primary/replica writes, objclass execution on the primary,
failure, peering/recovery — follow Ceph.  The accounting (client<->OSD
bytes vs OSD-local bytes processed) is what the paper's pushdown claims
are measured against in ``benchmarks/``.

Symmetric batched data plane: EVERY client<->OSD interaction goes
through one per-OSD batch RPC, so fabric ops scale with the number of
OSDs touched (K), never the number of objects (N):

  * reads/scans — ``exec_batch(names, ops)`` groups objects by primary
    OSD, ONE objclass request per OSD; ``ops`` may be a single shared
    pipeline or one pipeline per object;
  * aggregate scans — ``exec_combine(names, ops)`` additionally folds
    partials *on* each OSD (the tail op's associative ``merge``) and
    returns ONE partial per OSD, so ``client_rx`` is O(K) too;
  * writes — ``put_batch(names, blobs, xattrs)`` groups sub-writes by
    primary OSD (one request + server-side replication per object),
    with per-object failover inside the batch;
  * metadata — ``list_zone_maps(names)`` fetches many objects' xattrs
    in one request per OSD (one ``xattr_ops`` per request, not per
    object).

Streaming pipelined data plane: the O(K) request plane is also an
O(overlap) wall-clock plane.  ``put_batch(window_bytes=...)`` accepts a
lazy blob producer and flushes per-OSD sub-write groups into one
long-lived streaming request per primary OSD as each window fills, so
client-side encode overlaps the NIC stream (measured in
``Fabric.overlap_s`` / ``stream_windows``); ``exec_batch_iter`` /
``exec_combine_iter`` / ``exec_concat_iter`` are the read-side twins —
per-OSD result frames are delivered in completion order so the client
decodes early frames while slower OSDs are still scanning.  Replica
writes pipeline down a CHAIN (entry -> replica -> replica, Ceph's
primary-copy forwarding) instead of fanning out, halving the entry
OSD's replication egress (``Fabric.entry_egress_bytes``) at 3x
replication; ``replication="fanout"`` keeps the legacy topology for
comparison.

Every put stamps the object's xattr with a monotonic ``version`` tag;
clients cache zone maps keyed by (epoch, version) and revalidate prune
decisions against current versions, which closes the cross-client
stale-zone-map hazard (see ``GlobalVOL.plan``).

Every client<->OSD round trip is charged ``PER_REQUEST_OVERHEAD_BYTES``
into ``Fabric.overhead_bytes`` — the request-amplification cost that
batching amortizes.  All scatter/gather paths share one persistent
executor (``ObjectStore._pool``) instead of building a thread pool per
call, and skip thread fan-out entirely when no I/O is simulated
(``io_simulated`` — pure compute runs faster sequentially under the
GIL).

Failure model: ``fail_osd`` marks an OSD down (its data is *gone*, as a
disk loss); ``recover`` re-replicates every object that lost a replica
from a surviving copy, on the new cluster map.  Reads and objclass execs
transparently fail over to the next replica in the acting set; in a
batch, failed objects are re-grouped onto their next untried replica and
retried as new (batched) requests.

Self-healing plane (gray failures, not just fail-stop):

  * every write path (``put``, ``put_batch`` windows, each replication
    hop) stamps a content ``digest`` (``format.content_digest`` over the
    encoded blob) into the object's xattrs, so EVERY copy is
    independently verifiable;
  * every read verifies the served copy against its own digest; a
    divergent copy is quarantined on its OSD (``OSD.quarantine``) and
    surfaced as :class:`CorruptObject`, which the batched planes treat
    exactly like a missing replica — per-object failover to the next
    copy in the acting set (``Fabric.corruptions_detected`` counts the
    catches);
  * ``scrub()`` is the background maintenance pass: a per-OSD walker
    verifies every local copy, quarantines divergent/torn ones, and
    heals from the highest-version digest-verified copy through the
    replication chain; ``recover()`` is digest-verified too — it
    refuses a corrupt source, falls down the surviving copies, and
    raises :class:`DataLossError` (naming the objects) instead of
    silently under-reporting total loss;
  * transient request faults (:class:`TransientOSDError`, injected by
    ``core.faults.FaultInjector``) are retried inside the shared
    batched-failover skeleton with bounded exponential backoff under a
    per-request deadline (:class:`RetryPolicy`;
    ``Fabric.retries`` counts them); an exhausted budget escalates to
    replica failover, keeping the retryable/terminal distinction sharp.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json as _json
import queue as _queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core import expr as ex
from repro_torch.core.cache import Negative as _Negative, ResultCache, _MISS
from repro_torch.core.format import content_digest
from repro_torch.core.objclass import (
    ObjOp, apply_pipeline, compact_merge as _compact_merge_blocks,
    concat_encode, decode_pipeline,
    get_impl as _impl, has_hyperslab, has_row_slice, merge_partials,
    normalize_exprs, pipeline_digest, pipeline_mergeable,
    required_columns, resolve_hyperslab, resolve_row_slice,
    run_pipeline, table_n_rows, zone_map_prunes)
from repro_torch.core.placement import ClusterMap

# fixed cost modeled for one client<->OSD round trip (headers, framing,
# dispatch) — what per-object fan-out pays N times and a batch pays once
PER_REQUEST_OVERHEAD_BYTES = 128

# default ingest window for the streaming write plane: sub-write groups
# flush to their per-OSD streams every this-many encoded bytes, so the
# encoder runs at most one window ahead of the NIC
DEFAULT_WINDOW_BYTES = 8 << 20

# bounds for ``put_batch(window_bytes="adaptive")``: the per-window
# retarget W_next = W * encode_rate / NIC_rate is clamped to this range
# so one mis-measured window can neither collapse streaming to per-blob
# flushes nor balloon the ledger past a sane buffer
ADAPTIVE_WINDOW_FLOOR = 256 << 10
ADAPTIVE_WINDOW_CAP = 64 << 20


@dataclasses.dataclass
class Fabric:
    """Byte/op counters for the client<->storage network.

    Counters are exact for any single accounting thread: the store's
    internal workers (replica chains, stream feeders, scatter groups)
    never touch them — deltas are accumulated by the thread that issued
    the call.  Two *independent* client threads driving the store
    concurrently (a prefetching data loader beside an async
    checkpointer, say) interleave their updates without synchronization
    — read invariants around single-threaded windows, as the tests and
    benchmarks do."""

    client_tx: int = 0          # client -> OSD (writes)
    client_rx: int = 0          # OSD -> client (reads / results)
    replica_bytes: int = 0      # OSD -> OSD replication (all hops)
    entry_egress_bytes: int = 0  # replication bytes SENT BY the entry
    #                              OSD (chain: first hop only; fan-out:
    #                              every replica — the 2x the chain cuts)
    recovery_bytes: int = 0     # OSD -> OSD re-replication
    local_bytes: int = 0        # bytes processed inside OSDs (pushdown)
    ops: int = 0                # client<->OSD round trips (requests)
    overhead_bytes: int = 0     # per-request fixed cost (ops * 128 B)
    xattr_ops: int = 0          # metadata (xattr) lookups
    rx_frames: int = 0          # framed result payloads the client parsed
    stream_windows: int = 0     # windowed sub-write groups flushed +
    #                             result frames delivered while streaming
    overlap_s: float = 0.0      # encode time hidden behind an active
    #                             NIC stream (windowed ingest)
    scrub_bytes: int = 0        # bytes digest-verified by scrub walks
    corruptions_detected: int = 0  # divergent/torn copies caught (reads,
    #                                scrub, recover source vetting)
    heals: int = 0              # replica copies restored (scrub/recover)
    retries: int = 0            # transient-fault request retries
    cache_hits: int = 0         # served from an OSD result cache
    cache_misses: int = 0       # cache enabled but entry absent/stale
    cache_evictions: int = 0    # LRU entries dropped for the byte bound
    cache_bytes: int = 0        # bytes ADMITTED into OSD caches (a
    #                             monotonic counter like every other
    #                             field, not a residency gauge — see
    #                             stats()["cache_resident_bytes"])
    queue_wait_s: float = 0.0   # time requests blocked behind another
    #                             scan in an OSD's modeled service queue
    cache_neg_hits: int = 0     # nothing-to-serve answered from an OSD
    #                             negative-cache entry (missing/skipped/
    #                             pruned replays that bypassed the queue)
    chunks_pruned: int = 0      # array chunks dropped OSD-side by
    #                             per-chunk zone maps before any cell
    #                             of the chunk was touched
    replica_lat_s: float = 0.0  # modeled replication write latency
    #                             (chain: per-hop, sequential; fan-out:
    #                             one hop, parallel)
    # -- maintenance plane (core.maintenance daemons; each counter has
    #    ONE writer thread — the daemon that owns that work) --
    compactions: int = 0        # small-object runs folded (compact_merge)
    compaction_bytes: int = 0   # bytes read/shipped/written by compaction
    rebalance_bytes: int = 0    # bytes moved toward fresh placement by
    #                             the live rebalancer (old copies kept
    #                             until the new copy digest-verifies)
    gc_objects: int = 0         # dead versions + quarantined copies
    #                             reclaimed after the retention window
    gc_bytes: int = 0           # bytes those reclaims freed

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.client_tx = self.client_rx = 0
        self.replica_bytes = self.entry_egress_bytes = 0
        self.recovery_bytes = 0
        self.local_bytes = self.ops = 0
        self.overhead_bytes = self.xattr_ops = self.rx_frames = 0
        self.stream_windows = 0
        self.overlap_s = 0.0
        self.scrub_bytes = self.corruptions_detected = 0
        self.heals = self.retries = 0
        self.cache_hits = self.cache_misses = self.cache_evictions = 0
        self.cache_bytes = 0
        self.queue_wait_s = 0.0
        self.cache_neg_hits = self.chunks_pruned = 0
        self.replica_lat_s = 0.0
        self.compactions = self.compaction_bytes = 0
        self.rebalance_bytes = 0
        self.gc_objects = self.gc_bytes = 0


def _serve_meters() -> dict:
    """Per-request serve-plane meters: accumulated OSD-side while a
    batched request runs (possibly on a pool worker), shipped back in
    the response, and folded into the fabric by the CLIENT thread that
    issued the call — pool workers never touch fabric counters."""
    return {"cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
            "cache_bytes": 0, "queue_wait_s": 0.0,
            "neg_hits": 0, "chunks_pruned": 0}


class OSDDown(RuntimeError):
    pass


class ObjectNotFound(KeyError):
    pass


class TransientOSDError(RuntimeError):
    """A request-scoped gray failure: the OSD is up and its data is
    intact, but THIS request failed (dropped frame, brief overload).
    Retryable by definition — the batched planes retry it with bounded
    exponential backoff (``RetryPolicy``) before escalating to replica
    failover, unlike :class:`OSDDown` (terminal for that OSD)."""


class CorruptObject(Exception):
    """A stored copy failed digest verification (or lost its xattr in a
    torn write under a pipeline that needs it).  The divergent copy is
    already quarantined on its OSD when this surfaces; the client planes
    treat it like a missing replica and fail over to the next copy in
    the acting set."""


class DataLossError(RuntimeError):
    """Every replica of the named objects is lost or corrupt — there is
    no copy left to serve or heal from.  ``objects`` lists them.  Raised
    loudly by ``recover()`` (unless ``allow_loss=True``) and by the
    read/exec planes when failover exhausts an acting set on corrupt
    copies, instead of burying the loss in a stats dict.

    ``census`` maps each named object to its per-OSD copy census —
    ``{"verified": [osd...], "divergent": [osd...], "bare": [osd...],
    "quarantined": [osd...]}`` — so an operator can triage (is there a
    bare copy worth adopting? a quarantined one worth inspecting?)
    before opting into ``recover(allow_loss=True)``."""

    def __init__(self, objects: Sequence[str], msg: str | None = None,
                 census: dict | None = None):
        self.objects: tuple[str, ...] = tuple(objects)
        self.census: dict[str, dict[str, list[int]]] = dict(census or {})
        super().__init__(
            msg or ("all replicas lost or corrupt for "
                    f"{len(self.objects)} object(s): "
                    f"{list(self.objects[:8])}"
                    f"{'...' if len(self.objects) > 8 else ''}"))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-fault retry budget for one client request (a per-OSD
    group call in the batched planes, or one hop of a per-object path):
    up to ``attempts`` tries with exponential backoff ``base_s * 2**k``
    capped at ``cap_s``, never sleeping past the per-request
    ``deadline_s`` (None = no deadline).  Exhaustion is terminal for
    THAT replica — the item fails over down its acting set like any
    other per-object miss.

    ``jitter="decorrelated"`` switches the actual sleeps to AWS-style
    decorrelated jitter — ``sleep_k = min(cap_s, U(base_s,
    3*sleep_{k-1}))`` — so many waiters hammered off the same recovering
    OSD spread out instead of thundering back in lockstep.  The RNG is
    seeded from ``(seed, salt)`` so schedules are reproducible per
    waiter yet distinct across waiters.  ``give_up`` stays deterministic
    (it budgets against the un-jittered ``backoff_s`` curve)."""

    attempts: int = 4
    base_s: float = 0.002
    cap_s: float = 0.1
    deadline_s: float | None = None
    jitter: str = "none"          # "none" | "decorrelated"
    seed: int | None = None

    def backoff_s(self, attempt: int) -> float:
        return min(self.cap_s, self.base_s * (2 ** attempt))

    def give_up(self, attempt: int, t0: float) -> bool:
        """No budget left: attempts spent, or the next backoff sleep
        would cross the request deadline."""
        if attempt + 1 >= self.attempts:
            return True
        return self.deadline_s is not None and (
            time.perf_counter() - t0 + self.backoff_s(attempt)
            > self.deadline_s)

    def backoff(self, salt: int = 0) -> "_Backoff":
        """A per-waiter sleep generator.  ``salt`` distinguishes
        concurrent waiters sharing one policy (the batched planes pass a
        fresh salt per group call)."""
        return _Backoff(self, salt)

    def schedule(self, n: int, salt: int = 0) -> list[float]:
        """The first ``n`` sleeps one waiter would take — for tests
        asserting boundedness / non-synchronization without sleeping."""
        boff = self.backoff(salt)
        return [boff.next_s() for _ in range(n)]


class _Backoff:
    """Stateful per-waiter backoff: deterministic exponential by
    default, decorrelated-jitter when the policy asks for it.  One
    instance per (request, replica) — never shared across threads."""

    def __init__(self, policy: RetryPolicy, salt: int = 0):
        self._policy = policy
        self._attempt = 0
        self._prev = 0.0
        if policy.jitter == "decorrelated":
            seed = (((policy.seed or 0) * 0x9E3779B1 + salt)
                    & 0xFFFFFFFF)
            self._rng: random.Random | None = random.Random(seed)
        else:
            self._rng = None

    def next_s(self) -> float:
        p = self._policy
        if self._rng is None:
            s = p.backoff_s(self._attempt)
            self._attempt += 1
            return s
        lo = p.base_s
        hi = max(lo, 3.0 * (self._prev if self._prev > 0.0 else lo))
        s = min(p.cap_s, self._rng.uniform(lo, hi))
        self._prev = s
        return s


class TokenBucket:
    """Byte-rate limiter for the maintenance daemons: ``consume(n)``
    debits ``n`` bytes against a bucket refilled at ``rate_bytes_s``
    and sleeps until the balance is non-negative, so background work
    (scrub verify, rebalance copies, compaction gathers) trickles at a
    bounded rate instead of saturating the modeled disks/fabric under
    foreground scans.  ``rate_bytes_s=None`` disables limiting.  Burst
    capacity is one rate-second, so a single object larger than the
    rate still passes (after proportional sleep) instead of wedging.
    Thread-safe; each daemon usually owns its own bucket."""

    def __init__(self, rate_bytes_s: float | None):
        self.rate = float(rate_bytes_s) if rate_bytes_s else None
        self._lock = threading.Lock()
        self._balance = self.rate or 0.0  # start with a full burst
        self._last = time.monotonic()

    def consume(self, nbytes: int) -> float:
        """Debit ``nbytes``; sleep off any deficit.  Returns the sleep
        actually paid (seconds) for observability/tests."""
        if self.rate is None or nbytes <= 0:
            return 0.0
        with self._lock:
            now = time.monotonic()
            self._balance = min(
                self.rate, self._balance + (now - self._last) * self.rate)
            self._last = now
            self._balance -= float(nbytes)
            deficit = -self._balance
        if deficit <= 0.0:
            return 0.0
        wait = deficit / self.rate
        time.sleep(wait)
        return wait


class PartialWriteError(ValueError):
    """A windowed ``put_batch`` producer mismatch (ended early, or
    yielded extra items) detected only AFTER earlier sub-writes already
    persisted with stamped versions.  ``persisted`` lists those
    ``(name, version)`` pairs — everything else in the batch is NOT
    durable — so the caller can reconcile (delete, adopt, or retry the
    remainder) instead of guessing what landed."""

    def __init__(self, msg: str, persisted=()):
        super().__init__(msg)
        self.persisted: tuple[tuple[str, int], ...] = tuple(persisted)


class _WriteLedger:
    """Client-side retained-blob accounting for ONE ``put_batch`` call:
    a materialized sub-write blob is pinned (in-batch failover may need
    to resend it) until the write AND its replica chain land, then
    released — so a windowed stream retains O(window) bytes, not
    O(batch).  ``peak_bytes`` is the bound the regression tests gate."""

    def __init__(self, n: int):
        self.blobs: list[bytes | None] = [None] * n
        self.sizes: list[int] = [0] * n
        self.peak_bytes = 0
        self._bytes = 0
        self._lock = threading.Lock()

    def pin(self, i: int, blob: bytes) -> None:
        self.blobs[i] = blob
        self.sizes[i] = len(blob)
        with self._lock:
            self._bytes += len(blob)
            self.peak_bytes = max(self.peak_bytes, self._bytes)

    def release(self, i: int) -> None:
        if self.blobs[i] is None:
            return
        self.blobs[i] = None
        with self._lock:
            self._bytes -= self.sizes[i]


class OSD:
    """One storage server: object data + xattrs + a local op executor.

    ``latency_s`` simulates slow media / stragglers (used by the hedged-
    read tests); ``disk_bw`` (bytes/s, None = instant) serializes write
    cost per OSD — parallel writers to different OSDs overlap, writers to
    the same OSD queue, which is what makes paper-Table-1-style scaling
    measurable in-process.  ``scan_bw`` (bytes/s, None = instant) is the
    serve-side twin: pipeline decode time serialized through one service
    queue per OSD, so scan contention shows up in wall clock (and in
    ``Fabric.queue_wait_s``) — cache hits skip the queue entirely.
    ``cache_bytes`` bounds this OSD's :class:`ResultCache` (0 disables).
    """

    # lock-discipline contract:
    # these attributes may only be read or written inside a ``with
    # <osd>.lock`` body (any holder of the OSD reference — the store,
    # the fault injector, the maintenance plane — plays by the same
    # rule, since writers mutate them concurrently on pool workers)
    _GUARDED_BY = {"data": "lock", "xattrs": "lock",
                   "quarantine": "lock"}

    def __init__(self, osd_id: str, disk_bw: float | None = None, *,
                 scan_bw: float | None = None, cache_bytes: int = 0):
        self.osd_id = osd_id
        self.data: dict[str, bytes] = {}
        self.xattrs: dict[str, dict] = {}
        self.latency_s: float = 0.0
        self.disk_bw = disk_bw
        self.scan_bw = scan_bw
        self.cache = ResultCache(cache_bytes)
        self._service = threading.Lock()  # modeled scan service queue
        self.lock = threading.Lock()
        # request-entry fault hook (core.faults.FaultInjector): fires
        # once per client request served by this OSD, may sleep (slow
        # OSD) or raise TransientOSDError (fail-N-then-succeed)
        self.faults = None
        # divergent copies pulled out of service by digest verification
        # (reads or scrub): name -> (blob, xattr); kept for post-mortems,
        # never served again
        self.quarantine: dict[str, tuple[bytes, dict]] = {}

    def _touch(self) -> None:
        """One served client request: pay the configured latency and
        give the fault injector its shot (slow answer / transient
        failure) BEFORE any data is read or written."""
        if self.faults is not None:
            self.faults.on_request(self.osd_id)
        if self.latency_s:
            time.sleep(self.latency_s)

    def _quarantine_copy(self, name: str) -> None:
        with self.lock:
            blob = self.data.pop(name, None)
            xattr = self.xattrs.pop(name, None)
            if blob is not None:
                self.quarantine[name] = (blob, xattr or {})
        # a quarantined copy must never be served, cached forms included
        self.cache.invalidate(name)

    def _verify_copy(self, name: str, blob: bytes) -> CorruptObject | None:
        """Digest-check one local copy before serving it.  A copy whose
        xattr carries no ``digest`` (legacy/native write) is
        unverifiable and served as-is; a mismatch quarantines the copy
        and returns the :class:`CorruptObject` for the caller to
        surface (per-object failover)."""
        with self.lock:
            want = (self.xattrs.get(name) or {}).get("digest")
        if want is None or content_digest(blob) == int(want):
            return None
        self._quarantine_copy(name)
        return CorruptObject(f"{name} on {self.osd_id}: stored bytes "
                             "diverge from stamped digest")

    # -- local primitives (called by ObjectStore only) --
    def put(self, name: str, blob: bytes, xattr: dict | None = None) -> None:
        self._touch()
        with self.lock:
            if self.disk_bw:
                time.sleep(len(blob) / self.disk_bw)  # serial disk
            self.data[name] = bytes(blob)
            if xattr is not None:
                self.xattrs[name] = dict(xattr)
        self.cache.invalidate(name)  # rewrite: cached forms are stale

    def put_batch(self, items: Sequence[tuple[str, bytes, dict | None]],
                  stream: Callable[[int], None] | None = None,
                  landed: Callable[[int], None] | None = None) -> None:
        """One batched write request: store every (name, blob, xattr)
        locally.  The per-request latency is paid ONCE for the whole
        batch; per-blob disk time is still serialized (one disk).

        ``stream`` models the arriving client byte stream: it is called
        with each item's size just before that item's disk write (the
        store passes its NIC-transfer hook), so the shared client NIC
        serializes per sub-write instead of stalling behind one
        monolithic transfer.  NIC and disk time stay additive per
        sub-write — the same serial transport model as a single ``put``
        — so batching cuts request count and per-request overhead, never
        payload physics.  ``landed`` is called with each item's batch
        index right after its disk write — the store hangs the
        per-object replica fan-out off it, so replication starts per
        object instead of waiting for the whole batch."""
        self._touch()
        for k, (name, blob, xattr) in enumerate(items):
            if stream is not None:
                stream(len(blob))
            with self.lock:
                if self.disk_bw:
                    time.sleep(len(blob) / self.disk_bw)  # serial disk
                self.data[name] = bytes(blob)
                if xattr is not None:
                    self.xattrs[name] = dict(xattr)
            self.cache.invalidate(name)  # rewrite: cached forms stale
            if landed is not None:
                landed(k)

    def get(self, name: str) -> bytes:
        self._touch()
        with self.lock:
            if name not in self.data:
                raise ObjectNotFound(name)
            blob = self.data[name]
        bad = self._verify_copy(name, blob)
        if bad is not None:
            raise bad
        return blob

    def exec_cls(self, name: str, ops: list[ObjOp]) -> Any:
        """Run an objclass pipeline against a local object (SkyhookDM
        extension / custom read method)."""
        blob = self.get(name)
        ops = self._resolved(name, normalize_exprs(ops), clamp=True)
        return run_pipeline(blob, ops), len(blob)

    def compact_merge(self, blobs: Sequence[bytes], out_name: str,
                      xattr: dict | None = None) -> tuple[bytes, dict]:
        """OSD-side merge op (``objclass.compact_merge``): fold a run of
        consecutive small blocks into ONE block stored locally under
        ``out_name``, stamping a fresh zone map and content digest into
        its xattrs so the merged copy is verifiable and prunable like
        any written object.  Returns ``(blob, stamped_xattr)`` so the
        caller can replicate the merged object down the chain without
        re-reading it."""
        self._touch()
        blob, zm = _compact_merge_blocks(list(blobs))
        stamped = dict(xattr or {})
        stamped["zone_map"] = zm
        stamped["digest"] = content_digest(blob)
        with self.lock:
            if self.disk_bw:
                time.sleep(len(blob) / self.disk_bw)  # serial disk
            self.data[out_name] = bytes(blob)
            self.xattrs[out_name] = stamped
        self.cache.invalidate(out_name)
        return blob, stamped

    def _extent(self, name: str) -> tuple[int, int] | None:
        """The object's CURRENT row extent from its own ``rows`` xattr
        (written by the VOL write path) — what a pushed-down
        ``row_slice`` resolves against."""
        with self.lock:
            x = self.xattrs.get(name)
        r = (x or {}).get("rows")
        return (int(r[0]), int(r[1])) if r else None

    def _resolved(self, name: str, ops: list[ObjOp],
                  clamp: bool = False) -> list[ObjOp] | None:
        """Resolve any ``row_slice`` op (GLOBAL dataset rows) against
        the object's CURRENT extent xattr.  None (only when ``clamp``
        is False) means the slice is provably disjoint from the extent:
        the object serves no rows — a prune-equivalent skip."""
        if not has_row_slice(ops):
            return ops
        ext = self._extent(name)
        if ext is None:
            raise ValueError(
                f"{name}: row_slice needs the object's extent ('rows' "
                "xattr, written by the VOL write path) to resolve")
        return resolve_row_slice(ops, ext, clamp=clamp)

    def _snapshot_copy(
            self, name: str) -> tuple[bytes | None, dict | None]:
        """One local copy AND its xattr under a single lock acquisition
        — the batched serve plane works from this snapshot so a
        concurrent writer can never pair one version's blob with
        another version's extent/digest mid-request."""
        with self.lock:
            blob = self.data.get(name)
            x = self.xattrs.get(name)
            return blob, (dict(x) if x is not None else None)

    def _pay_service(self, nbytes: int, meters: dict) -> None:
        """Pay the modeled decode service for one scanned blob: decode
        time (``nbytes / scan_bw``) serialized through this OSD's one
        service queue.  Time spent blocked behind other scans is the
        request's queue wait; cache hits never call this — skipping the
        queue is the latency win the serve plane buys."""
        if not self.scan_bw or nbytes <= 0:
            return
        t0 = time.perf_counter()
        with self._service:
            meters["queue_wait_s"] += time.perf_counter() - t0
            time.sleep(nbytes / self.scan_bw)

    def _decoded_table(self, name: str, version, blob: bytes,
                       resolved: list[ObjOp],
                       meters: dict) -> tuple[dict, int]:
        """The decoded column table a pipeline needs, through the
        decode-level cache (shared across pipelines that read the same
        columns).  Returns ``(table, scanned_bytes)`` — 0 scanned when
        the decode was elided (no storage bytes were read)."""
        key = None
        if self.cache.capacity > 0 and version is not None:
            cols = required_columns(resolved)
            key = (name, int(version), "cols",
                   tuple(cols) if cols is not None else None)
            got = self.cache.get(key)
            if got is not _MISS:
                return got, 0
        self._pay_service(len(blob), meters)
        table = decode_pipeline(blob, resolved)
        if key is not None:
            ev, ins = self.cache.put(key, table, _result_nbytes(table))
            meters["cache_evictions"] += ev
            meters["cache_bytes"] += ins
        return table, len(blob)

    def _serve_item(self, name: str, ops: list[ObjOp], kind: str,
                    dig: str | None, meters: dict, *,
                    clamp: bool = False, encode: bool = True,
                    prune=None, pdig: str | None = None
                    ) -> tuple[str, Any, int]:
        """Serve one item of a batched objclass request through the
        result cache.  Returns ``(status, payload, scanned_bytes)``
        with status one of ``"ok"`` (payload = pipeline result),
        ``"missing"`` (absent here), ``"corrupt"`` (payload = the
        :class:`CorruptObject`; the copy is quarantined), or ``"skip"``
        (row slice provably disjoint — prune-equivalent).

        ``kind`` namespaces the result-cache key per response mode
        (plain/combine/concat clamp and encode differently, so one
        pipeline digest can map to different payloads).  Cached entries
        are keyed by the snapshot's monotonic version: any write, heal,
        or compaction bumps it, so an entry can never be served across
        a version bump — and every entry was derived from a
        digest-verified blob at insert time.

        ``prune`` (with its digest ``pdig``) is the request's pushdown
        expression: a hyperslab pipeline resolves it against per-chunk
        zone maps, so for those items it becomes part of the result's
        identity — the cache key digest is extended with ``pdig`` and
        the chunk-prune work is metered as ``chunks_pruned``.  A
        nothing-to-serve outcome (absent object, disjoint slice, every
        chunk pruned) is *negatively* cached under the same versioned
        key scheme (version -1 for absence, retired by the eager
        invalidation every write path performs), so a replay skips
        digest verification and op resolution — metered ``neg_hits``."""
        if prune is not None and dig is not None and has_hyperslab(ops):
            dig = f"{dig}|{pdig}"  # result content depends on the prune
        if self.cache.capacity > 0 and dig is not None:
            got = self.cache.get((name, -1, kind + "#neg", dig))
            if isinstance(got, _Negative):
                meters["neg_hits"] += 1
                return got.reason, None, 0
        blob, xattr = self._snapshot_copy(name)
        if blob is None:
            if self.cache.capacity > 0 and dig is not None:
                self.cache.put_negative(
                    (name, -1, kind + "#neg", dig), "missing")
            return "missing", None, 0
        version = (xattr or {}).get("version")
        key = negkey = None
        if (self.cache.capacity > 0 and version is not None
                and dig is not None):
            key = (name, int(version), kind, dig)
            got = self.cache.get(key)
            if got is not _MISS:
                meters["cache_hits"] += 1
                return "ok", got, 0
            negkey = (name, int(version), kind + "#neg", dig)
            got = self.cache.get(negkey)
            if isinstance(got, _Negative):
                meters["neg_hits"] += 1
                return got.reason, None, 0
        # miss: digest-verify THIS snapshot's blob, resolve any row
        # slice against the SAME snapshot's extent, then decode
        want = (xattr or {}).get("digest")
        if want is not None and content_digest(blob) != int(want):
            self._quarantine_copy(name)
            return "corrupt", CorruptObject(
                f"{name} on {self.osd_id}: stored bytes diverge from "
                "stamped digest"), 0
        if has_row_slice(ops):
            r = (xattr or {}).get("rows")
            if r is None:
                if xattr is None:  # TORN write: blob landed, xattr not
                    self._quarantine_copy(name)
                    return "corrupt", CorruptObject(
                        f"{name} on {self.osd_id}: torn write (blob "
                        "landed, xattr missing) cannot serve a row "
                        "slice"), 0
                raise ValueError(  # bare extent-less xattr: caller misuse
                    f"{name}: row_slice needs the object's extent "
                    "('rows' xattr, written by the VOL write path) to "
                    "resolve")
            resolved = resolve_row_slice(
                ops, (int(r[0]), int(r[1])), clamp=clamp)
            if resolved is None:
                if negkey is not None:
                    self.cache.put_negative(negkey, "skip")
                return "skip", None, 0
        else:
            resolved = ops
        if has_hyperslab(resolved):
            ch = (xattr or {}).get("chunks")
            if ch is None:
                if xattr is None:  # TORN write: blob landed, xattr not
                    self._quarantine_copy(name)
                    return "corrupt", CorruptObject(
                        f"{name} on {self.osd_id}: torn write (blob "
                        "landed, xattr missing) cannot serve a "
                        "hyperslab"), 0
                raise ValueError(
                    f"{name}: hyperslab_slice needs the object's chunk "
                    "extent ('chunks' xattr, written by the VOL array "
                    "write path) to resolve")
            resolved, n_chunks_pruned = resolve_hyperslab(
                resolved, (int(ch[0]), int(ch[1])),
                chunk_zone_maps=(xattr or {}).get("chunk_zone_maps"),
                where=prune, clamp=clamp)
            meters["chunks_pruned"] += n_chunks_pruned
            if resolved is None:
                if negkey is not None:
                    self.cache.put_negative(negkey, "skip")
                return "skip", None, 0
        if resolved and resolved[0].name == "select_packed":
            # packed row-copy works on the raw blob — no decoded table
            # to share, so it bypasses the decode-level cache
            self._pay_service(len(blob), meters)
            result = run_pipeline(blob, resolved, encode=encode)
            scanned = len(blob)
        else:
            table, scanned = self._decoded_table(
                name, version, blob, resolved, meters)
            result = apply_pipeline(table, resolved, encode=encode)
        if key is not None:
            meters["cache_misses"] += 1
            ev, ins = self.cache.put(key, result, _result_nbytes(result))
            meters["cache_evictions"] += ev
            meters["cache_bytes"] += ins
        return "ok", result, scanned

    def _prunes_locally(self, name: str, prune, pdig: str | None = None,
                        meters: dict | None = None) -> bool:
        """Pushed-down prune: does this object's CURRENT local zone map
        prove the filter expression matches none of its rows?  Runs
        against the OSD's own xattrs, so the decision can never be
        stale — there is no client cache (and no plan→execute TOCTOU
        window) in the loop.

        With ``pdig`` (the request prune expression's digest) the
        decision itself is cached per ``(name, version, pdig)`` — a
        version bump retires it like any result entry — so a repeat
        scan of a pruned object skips the tree walk; replayed *pruned*
        verdicts are metered ``neg_hits``."""
        if prune is None:
            return False
        with self.lock:
            x = self.xattrs.get(name)
        if x is None:
            return False
        key = None
        if (pdig is not None and self.cache.capacity > 0
                and x.get("version") is not None):
            key = (name, int(x["version"]), "prune", pdig)
            got = self.cache.get(key)
            if got is not _MISS:
                if got and meters is not None:
                    meters["neg_hits"] += 1
                return bool(got)
        verdict = zone_map_prunes(x.get("zone_map", {}), prune)
        if key is not None:
            self.cache.put(key, verdict, _Negative.NBYTES)
        return verdict

    def exec_cls_batch(
            self, items: Sequence[tuple[str, list[ObjOp]]],
            combine: bool = False, concat: bool = False,
            prune=None) -> Any:
        """One batched objclass request: run each (name, pipeline) item
        against local data.  The per-request latency is paid ONCE for
        the whole batch — that is the round-trip amortization batching
        buys.  Per-item failures come back as ``ObjectNotFound`` values
        (not raises) so the rest of the batch still completes.

        ``prune`` is an optional filter-expression tree (the serialized
        wire dict of ``expr.Expr``, or the legacy tuple of
        (col, cmp, value) triples) pushed down with the request: before
        scanning an object the OSD consults its local zone-map xattr
        and skips objects the expression provably cannot match — the
        pruned names ride back in the response (they are a semantic
        skip, not an absence, so the client must not fail them over).
        Only the combine/concat forms accept it (plain responses are
        positional).  A ``row_slice`` op in a pipeline is resolved here
        against each object's own extent xattr; an object whose extent
        is disjoint from the slice is skipped the same prune-equivalent
        way (combine/concat) or serves zero rows (plain batch).

        Every served copy is verified against its stamped content
        digest first; a divergent (or torn, under a row slice) copy is
        quarantined and reported in the response's ``corrupt_names`` —
        the client retries those objects on their next replica exactly
        like missing ones, and counts them in
        ``Fabric.corruptions_detected``.

        With ``combine=True`` the items must share one decomposable
        pipeline whose tail has an associative ``merge``: the OSD folds
        its local partials into ONE and returns a
        ``(partial|None, n_found, scanned_bytes, missing_names,
        pruned_names, corrupt_names)`` tuple — a single partial leaves
        the OSD per request, not one per object (the server-side half
        of the two-level combine).

        With ``concat=True`` every item's pipeline must be table-out:
        the OSD concatenates the per-object result tables (item order)
        and encodes them as ONE framed block, returning
        ``(blob|None, served_indices, row_counts, scanned_bytes,
        missing_names, pruned_names, corrupt_names)`` — the table-out
        half of the same symmetry, bounding per-OSD response framing at
        one frame.

        Every response additionally carries a trailing serve-meters
        dict (``_serve_meters()``): per-request cache hit/miss/eviction
        and queue-wait deltas, folded into the fabric by the client
        thread that issued the call.  Results are served through this
        OSD's :class:`ResultCache` when it is enabled — a hit skips
        digest re-verification, decode, AND the modeled service queue
        (the entry was derived from a digest-verified blob at the same
        monotonic version, so the bytes are provably identical), and
        reports 0 scanned bytes because no storage bytes were read.
        """
        if combine and concat:
            raise ValueError("combine and concat are exclusive")
        self._touch()
        prune = ex.ensure_pred(prune)  # parse the wire form ONCE
        # ...and likewise each pipeline's serialized filter trees (a
        # shared pipeline object is normalized once for the whole batch)
        norm: dict[int, list[ObjOp]] = {}
        items = [(name,
                  norm[id(ops)] if id(ops) in norm
                  else norm.setdefault(id(ops), normalize_exprs(ops)))
                 for name, ops in items]
        meters = _serve_meters()
        # the prune expression's own digest: keys cached prune verdicts
        # and extends hyperslab result keys (their content depends on it)
        pdig = None
        if prune is not None and self.cache.capacity > 0:
            pdig = hashlib.sha1(_json.dumps(
                prune.to_json(), sort_keys=True,
                separators=(",", ":")).encode()).hexdigest()
        # one digest per distinct pipeline object (shared pipelines are
        # common: combine/concat batches reuse ONE list for all items)
        digs: dict[int, str] = {}

        def dig_of(ops: list[ObjOp]) -> str | None:
            if self.cache.capacity <= 0:
                return None  # cache off: skip the hashing entirely
            d = digs.get(id(ops))
            if d is None:
                d = digs.setdefault(id(ops), pipeline_digest(ops))
            return d

        if not combine and not concat:
            if prune is not None:
                raise ValueError("prune needs combine or concat "
                                 "(plain batch responses are positional)")
            out: list[Any] = []
            for name, ops in items:
                status, payload, scanned = self._serve_item(
                    name, ops, "plain", dig_of(ops), meters, clamp=True)
                if status == "missing":
                    out.append(ObjectNotFound(name))
                elif status == "corrupt":
                    out.append(payload)  # quarantined: per-item failover
                else:  # "skip" cannot happen under clamp=True
                    out.append((payload, scanned))
            return out, meters

        pruned: list[str] = []
        missing: list[str] = []
        corrupt: list[str] = []
        scanned = 0
        if concat:
            tables: list[dict] = []
            served: list[int] = []
            counts: list[int] = []
            for k, (name, ops) in enumerate(items):
                if self._prunes_locally(name, prune, pdig, meters):
                    pruned.append(name)
                    continue
                status, out, nb = self._serve_item(
                    name, ops, "concat", dig_of(ops), meters,
                    encode=False, prune=prune, pdig=pdig)
                if status == "missing":  # absent HERE: registers as
                    missing.append(name)  # missing (replica failover),
                    continue  # even if a row slice might have skipped it
                if status == "corrupt":
                    corrupt.append(name)  # quarantined: replica failover
                    continue
                if status == "skip":  # row slice disjoint: no rows here
                    pruned.append(name)
                    continue
                if not isinstance(out, dict) or (
                        ops and not _impl(ops[-1].name).table_out):
                    raise ValueError("concat needs table-out pipelines")
                scanned += nb
                tables.append(out)
                served.append(k)
                counts.append(table_n_rows(out))
            frame = concat_encode(tables) if tables else None
            return (frame, tuple(served), tuple(counts), scanned,
                    tuple(missing), tuple(pruned), tuple(corrupt),
                    meters)

        ops = items[0][1]
        partials: list[Any] = []
        for name, _ in items:
            if self._prunes_locally(name, prune, pdig, meters):
                pruned.append(name)
                continue
            status, partial, nb = self._serve_item(
                name, ops, "combine", dig_of(ops), meters,
                prune=prune, pdig=pdig)
            if status == "missing":  # absent HERE: replica failover
                missing.append(name)
                continue
            if status == "corrupt":
                corrupt.append(name)  # quarantined: replica failover
                continue
            if status == "skip":  # row slice disjoint: no rows here
                pruned.append(name)
                continue
            partials.append(partial)
            scanned += nb
        merged = merge_partials(ops, partials) if partials else None
        return (merged, len(partials), scanned, tuple(missing),
                tuple(pruned), tuple(corrupt), meters)

    def list_xattrs(self, names: Sequence[str]) -> dict[str, dict]:
        """One batched metadata request: the xattrs of every local object
        among ``names`` (absent names are simply omitted).  Request
        latency is paid once for the whole listing."""
        self._touch()
        out: dict[str, dict] = {}
        for name in names:
            with self.lock:
                x = self.xattrs.get(name)
            if x is not None:
                out[name] = dict(x)
        return out

    def nbytes(self) -> int:
        with self.lock:
            return sum(len(b) for b in self.data.values())

    def object_names(self) -> set[str]:
        with self.lock:
            return set(self.data)


class ObjectStore:
    """The cluster: cluster map + OSD daemons + client entry points.

    ``client_bw`` (bytes/s, None = instant) models the client's shared
    NIC: all client<->OSD transfers serialize through one link, so
    parallel writers amortize OSD work but not the forwarding hop — the
    paper's Table-1 structure.
    """

    # lock-discipline contract: the monotonic write clock is bumped by
    # every writer thread concurrently
    _GUARDED_BY = {"_vclock": "_lock"}

    def __init__(self, cluster: ClusterMap, *,
                 client_bw: float | None = None,
                 disk_bw: float | None = None,
                 scan_bw: float | None = None,
                 cache_bytes: int = 0,
                 replication: str = "chain",
                 hop_latency_s: float = 0.0,
                 retry: RetryPolicy | None = None):
        if replication not in ("chain", "fanout"):
            raise ValueError(f"bad replication topology {replication!r}; "
                             "known: ('chain', 'fanout')")
        self.cluster = cluster
        self.client_bw = client_bw
        self.disk_bw = disk_bw
        # serve-plane knobs (per OSD): modeled scan/decode bandwidth
        # and the result-cache byte bound — 0 disables caching, which
        # is the default so cold stores pay nothing
        self.scan_bw = scan_bw
        self.cache_bytes = int(cache_bytes or 0)
        self.replication = replication
        # modeled OSD->OSD forwarding delay per replication hop (0 =
        # latency-free, the pre-existing behavior): chain hops pay it
        # sequentially, fan-out pays it once — see _replicate
        self.hop_latency_s = float(hop_latency_s or 0.0)
        # transient-fault budget for every client request (see
        # RetryPolicy); injectable per store so tests/benchmarks can
        # tighten the deadline or disable backoff
        self.retry = retry or RetryPolicy()
        # per-waiter salt for jittered backoff: each retry loop takes a
        # fresh value so concurrent waiters get distinct sleep schedules
        self._salt = itertools.count()
        # the attached FaultInjector (core.faults), if any — kept here
        # so fail_osd/add_osds re-wire replacement OSD objects to it
        self.faults = None
        # the attached MaintenancePlane (core.maintenance), if any —
        # fail_osd/add_osds notify it so the rebalancer wakes up, and
        # close() stops its daemons
        self.maintenance = None
        self.osds: dict[str, OSD] = {
            o: OSD(o, disk_bw, scan_bw=scan_bw,
                   cache_bytes=self.cache_bytes)
            for o in cluster.osds}
        self.fabric = Fabric()
        self._lock = threading.Lock()
        self._nic = threading.Lock()
        # monotonic write clock: every put stamps its object's xattr
        # with a fresh ``version`` so ANY client can detect that a
        # cached zone map is stale (cross-client coherence)
        self._vclock = 0
        # persistent scatter/gather executor for every batched plane —
        # no per-call ThreadPoolExecutor churn.  Sized at 2x the OSD
        # count so windowed ingest can hold one streaming request per
        # primary OSD AND still run the per-object replica chains that
        # hang off their ``landed`` hooks concurrently.
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 2 * len(self.osds)),
            thread_name_prefix="store-io")
        # hedged reads get their own small persistent pool: an abandoned
        # straggler parks on a worker for its full latency and must not
        # starve exec_batch dispatch on the main pool
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="store-hedge")
        # observability for the write ledger: the peak retained-blob
        # bytes of the most recent put_batch on THIS store (windowed
        # streams stay O(window); per-call, so concurrent writers
        # should read it between their own calls)
        self.last_put_ledger_peak_bytes = 0
        # the window-size trajectory of the most recent adaptive
        # put_batch (one entry per retarget) — same per-call caveat
        self.last_adaptive_windows: tuple[int, ...] = ()

    def close(self) -> None:
        if self.maintenance is not None:
            try:
                self.maintenance.stop()
            except Exception:
                pass
        self._pool.shutdown(wait=False)
        self._hedge_pool.shutdown(wait=False)

    def __del__(self):  # release pool threads when the store dies
        try:
            self.close()
        except Exception:
            pass

    def _client_xfer(self, nbytes: int) -> None:
        if self.client_bw:
            with self._nic:  # one NIC: transfers serialize
                time.sleep(nbytes / self.client_bw)

    def _account_request(self) -> None:
        """One client<->OSD round trip: an op + its fixed overhead."""
        self.fabric.ops += 1
        self.fabric.overhead_bytes += PER_REQUEST_OVERHEAD_BYTES

    def _apply_meters(self, m: dict) -> None:
        """Fold one batched response's serve meters into the fabric —
        always on the client thread that issued the request (the OSD
        serve path may have run on a pool worker, which never touches
        fabric counters)."""
        f = self.fabric
        f.cache_hits += m["cache_hits"]
        f.cache_misses += m["cache_misses"]
        f.cache_evictions += m["cache_evictions"]
        f.cache_bytes += m["cache_bytes"]
        f.queue_wait_s += m["queue_wait_s"]
        f.cache_neg_hits += m.get("neg_hits", 0)
        f.chunks_pruned += m.get("chunks_pruned", 0)

    def io_simulated(self) -> bool:
        """True when requests actually *wait* (NIC/disk bandwidth or OSD
        latency is modeled).  Only then is thread fan-out worth it —
        pure in-process compute runs faster sequentially (GIL)."""
        return bool(self.client_bw or self.disk_bw or self.scan_bw
                    or any(o.latency_s for o in self.osds.values()))

    def default_window_bytes(self) -> int | None:
        """The ingest window callers should pass to ``put_batch`` when
        they have no opinion: windowed streaming only pays off when
        transfers actually take time — pure in-process writes run
        faster through the buffered path (no feeder threads)."""
        return DEFAULT_WINDOW_BYTES if self.io_simulated() else None

    def _replicate(self, name: str, blob: bytes, xattr: dict,
                   acting: Sequence[str],
                   entry: str | None = None) -> tuple[int, int, float]:
        """Server-side replication of one landed write from ``entry``
        (the OSD that took it — the primary, or a later replica after
        failover) across the rest of the acting set; returns
        ``(total_bytes_moved, bytes_sent_by_entry, latency_s)`` for the
        caller to charge to ``replica_bytes`` / ``entry_egress_bytes``
        / ``replica_lat_s`` — counters are never touched from
        replication worker threads (lost-update hazard under concurrent
        ``+=``).

        ``hop_latency_s`` models the per-hop forwarding delay and makes
        the chain-vs-fanout *latency* tradeoff observable next to the
        bandwidth one: a chain is store-and-forward, so its hops
        serialize (latency = transferred_hops x hop; each hop sleeps in
        turn on the replication worker), while fan-out sends in
        parallel from the entry OSD (latency = one hop regardless of
        replica count) — the exact mirror of the egress asymmetry
        ``entry_egress_bytes`` exposes, where the chain wins.

        ``chain`` (default) pipelines entry -> replica -> replica, the
        way Ceph forwards primary-copy writes: each hop moves the blob
        once and only the FIRST hop leaves the entry OSD, so the entry's
        egress is one blob regardless of the replica count (half the
        fan-out egress at 3x replication) — tracked separately in
        ``entry_egress_bytes``.  A down OSD mid-chain is skipped and the
        chain continues from the last OSD that holds the blob (per-
        object failover; peering re-replicates the skipped copy later),
        so only hops that actually transferred are charged.

        ``fanout`` is the legacy topology: the entry OSD sends to every
        replica directly (entry egress = (replicas - 1) blobs).
        """
        entry = acting[0] if entry is None else entry
        sender = entry
        moved = entry_moved = 0
        lat = 0.0
        hop = float(self.hop_latency_s or 0.0)
        for rep in acting:
            if rep == entry:
                continue
            try:
                if hop and self.replication == "chain":
                    time.sleep(hop)  # store-and-forward: hops serialize
                self._hop_put(rep, name, blob, xattr)
            except (OSDDown, TransientOSDError):
                continue  # skipped hop: peering/recovery heals it
            moved += len(blob)
            if hop and self.replication == "chain":
                lat += hop
            if self.replication == "fanout" or sender == entry:
                entry_moved += len(blob)
            if self.replication == "chain":
                sender = rep  # the new tail forwards the next hop
        if hop and self.replication != "chain" and moved:
            time.sleep(hop)  # parallel sends: ONE hop of latency
            lat = hop
        return moved, entry_moved, lat

    def _hop_put(self, osd_id: str, name: str, blob: bytes,
                 xattr: dict | None) -> None:
        """One OSD->OSD replication/heal hop, retrying transient faults
        in place (the hop runs on a replication worker, so the backoff
        sleep never blocks the client; fabric counters are untouched
        here).  Exhausted budgets re-raise and the hop is skipped like
        a down OSD — peering/scrub heals the copy later."""
        boff = self.retry.backoff(salt=next(self._salt))
        for attempt in range(max(1, self.retry.attempts)):
            try:
                return self._osd(osd_id).put(name, blob, xattr)
            except TransientOSDError:
                if attempt + 1 >= max(1, self.retry.attempts):
                    raise
                time.sleep(boff.next_s())

    # ------------------------------------------------------------ helpers
    def _acting(self, name: str) -> tuple[str, ...]:
        s = self.cluster.locate(name)
        if not s:
            raise OSDDown("no up OSDs for " + name)
        return s

    def _osd(self, osd_id: str) -> OSD:
        if osd_id in self.cluster.down:
            raise OSDDown(osd_id)
        return self.osds[osd_id]

    def _next_version(self) -> int:
        with self._lock:
            self._vclock += 1
            return self._vclock

    def _next_targets(self, pending: list[int], names: list[str],
                      tried: list[set],
                      last_err: list | None = None,
                      skipped: list[int] | None = None
                      ) -> list[tuple[str, list[int]]]:
        """Group pending item indices by their next untried acting OSD —
        the shared regrouping step of every batched plane's failover
        loop.  An item with no replicas left either raises its last
        error (default, mirroring the per-object paths) or is appended
        to ``skipped`` when the caller tolerates absence."""
        groups: dict[str, list[int]] = {}
        for i in pending:
            acting = self._acting(names[i])
            target = next((o for o in acting if o not in tried[i]), None)
            if target is None:
                if skipped is not None:
                    skipped.append(i)
                    continue
                err = last_err[i] if last_err is not None else None
                if isinstance(err, CorruptObject):
                    # not mere absence: the last surviving copy failed
                    # digest verification — the object is GONE, loudly
                    raise DataLossError(
                        [names[i]],
                        f"{names[i]}: every replica lost or corrupt "
                        f"(last: {err})",
                        census=self.copy_census([names[i]]))
                raise err or ObjectNotFound(names[i])
            groups.setdefault(target, []).append(i)
        # one order for dispatch AND result pairing — keep them the same
        return sorted(groups.items())

    def _retrying(self, run_group):
        """Wrap a per-OSD group call with the store's transient-fault
        policy: a :class:`TransientOSDError` escaping the group (the
        OSD dropped THIS request, it is not down) sleeps a bounded
        exponential backoff and re-issues, until the attempt budget or
        the per-request deadline runs out — then the error is returned
        as the group result (terminal for that replica; the items fail
        over down their acting sets like any whole-request failure).
        Returns ``(result, n_retries)`` so the CALLER thread can
        account ``Fabric.retries`` (wrapped calls may run on pool
        workers, which never touch fabric counters)."""
        policy = self.retry

        def run(osd_id, idxs):
            t0 = time.perf_counter()
            retries = 0
            boff = policy.backoff(salt=next(self._salt))
            while True:
                try:
                    return run_group(osd_id, idxs), retries
                except TransientOSDError as e:
                    if policy.give_up(retries, t0):
                        return e, retries
                    time.sleep(boff.next_s())
                    retries += 1
        return run

    def _dispatch_groups(self, ordered, run_group) -> list:
        """Fan the per-OSD group requests out on the persistent pool —
        but only when requests actually block on simulated I/O; compute-
        bound groups run inline (threads just add GIL contention).
        Transient faults retry inside each group call (``_retrying``);
        the retry count accrues to ``Fabric.retries`` here, on the
        caller's thread."""
        run = self._retrying(run_group)
        if len(ordered) == 1 or not self.io_simulated():
            outs = [run(osd_id, idxs) for osd_id, idxs in ordered]
        else:
            futs = [self._pool.submit(run, osd_id, idxs)
                    for osd_id, idxs in ordered]
            outs = [f.result() for f in futs]
        results = []
        for got, retries in outs:
            self.fabric.retries += retries
            results.append(got)
        return results

    def _scatter_iter(self, names: list[str], run_group, handle,
                      stream: bool = False,
                      completion_order: bool | None = None
                      ) -> Iterator[Any]:
        """The shared replica-failover skeleton of the batched read
        planes (``exec_batch`` / ``exec_combine`` / ``exec_concat``),
        as a generator: group pending items by their next untried
        acting OSD, dispatch one batched request per group, account the
        round trip, and let ``handle`` consume each per-group response
        — returning ``(retry_indices, emitted_items)``.  Under
        ``completion_order`` (default: follows ``stream``) emitted
        items are yielded the moment THEIR group's response lands, so a
        streaming consumer decodes early frames while slower OSDs are
        still scanning; otherwise groups are consumed in dispatch
        (sorted-OSD) order, which keeps order-sensitive reductions —
        float partial folds — bit-deterministic run to run.  Under
        ``stream=True`` each delivered item also counts in
        ``Fabric.stream_windows``.  A whole-request failure (OSD down)
        retries every item of its group."""
        if completion_order is None:
            completion_order = stream
        tried: list[set[str]] = [set() for _ in names]
        last_err: list[Exception | None] = [None] * len(names)
        pending = list(range(len(names)))
        run = self._retrying(run_group)  # transient backoff per group
        while pending:
            ordered = self._next_targets(pending, names, tried, last_err)
            pending = []
            if len(ordered) == 1 or not self.io_simulated():
                completions = ((pair, run(*pair))
                               for pair in ordered)
            else:
                futs = {self._pool.submit(run, o, idxs): (o, idxs)
                        for o, idxs in ordered}
                completions = ((futs[f], f.result())
                               for f in (as_completed(futs)
                                         if completion_order else futs))
            for (osd_id, idxs), (got, retries) in completions:
                self._account_request()  # one round trip per OSD group
                self.fabric.retries += retries
                for i in idxs:
                    tried[i].add(osd_id)
                if isinstance(got, Exception):
                    for i in idxs:
                        last_err[i] = got
                    pending.extend(idxs)
                    continue
                retry, emitted = handle(idxs, got, last_err)
                pending.extend(retry)
                for item in emitted:
                    if stream:
                        self.fabric.stream_windows += 1
                    yield item

    # ------------------------------------------------------------ client IO
    def put(self, name: str, blob: bytes, xattr: dict | None = None) -> int:
        """Replicated write: client -> primary -> replica chain.  Client
        pays one transfer; replication is server-side (``_replicate``:
        chain-pipelined by default, matching Ceph's primary-copy
        forwarding).  The object's xattr is stamped with a fresh
        monotonic ``version``, which is returned.  The xattr also gets
        a content ``digest`` of the blob, so every replica (the chain
        forwards blob AND xattr together) is independently verifiable
        by reads, ``scrub()`` and ``recover()``."""
        version = self._next_version()
        stamped = {**(xattr or {}), "version": version,
                   "digest": content_digest(blob)}
        acting = self._acting(name)
        self.fabric.client_tx += len(blob)
        self._account_request()
        self._client_xfer(len(blob))
        self._osd(acting[0]).put(name, blob, stamped)
        # replication is OSD->OSD (cluster network), not client bytes
        moved, entry_moved, lat = self._replicate(
            name, blob, stamped, acting)
        self.fabric.replica_bytes += moved
        self.fabric.entry_egress_bytes += entry_moved
        self.fabric.replica_lat_s += lat
        return version

    def put_batch(self, names: Iterable[str],
                  blobs: Iterable[bytes | tuple[bytes, dict | None]],
                  xattrs: Sequence[dict | None] | None = None, *,
                  window_bytes: int | str | None = None,
                  window_objects: int | None = None) -> list[int]:
        """Batched replicated write: ONE client request per primary OSD.

        Sub-writes are grouped by their primary OSD and each group goes
        out as a single ``OSD.put_batch`` round trip, so ingesting N
        objects over K OSDs costs K fabric ops instead of N.
        Replication stays server-side per object (``_replicate``: the
        entry OSD chain-forwards down the acting set the moment that
        object's primary write lands, charged to ``replica_bytes`` /
        ``entry_egress_bytes``).  Objects whose group request failed
        (entry OSD down mid-batch) are re-grouped onto their next
        untried replica and retried as fresh batched requests —
        per-object failover inside the batch, mirroring ``exec_batch``.

        **Windowed streaming mode** (``window_bytes`` and/or
        ``window_objects``): ``blobs`` may be a lazy iterable — a
        generator still *encoding* — and sub-writes flush to ONE
        long-lived streaming request per primary OSD as each window
        fills, so client-side encode overlaps the NIC stream instead of
        buffering the whole batch first.  Still exactly one fabric op
        per OSD touched (the stream is one request), identical payload
        accounting, and bit-identical stored bytes; each flushed
        per-OSD sub-write group counts in ``Fabric.stream_windows`` and
        the encode time hidden behind an active stream accrues to
        ``Fabric.overlap_s``.  In this mode an element of ``blobs`` may
        also be a ``(blob, xattr)`` pair, letting one generator produce
        payload and metadata together (``xattrs`` entries are the
        fallback).  Sub-writes whose stream died mid-flight fail over
        through the buffered retry rounds — their blobs are still
        pinned in the write ledger.  The ledger releases each blob the
        moment its write AND replica chain land (no retry can resend
        it), so a long stream retains O(window) bytes, not O(batch) —
        ``last_put_ledger_peak_bytes`` records the peak.  Length
        validation is necessarily lazy here: a producer that ends early
        (or yields extra items) raises :class:`PartialWriteError` only
        once the mismatch is SEEN — after the already-produced
        sub-writes persisted with stamped versions; the exception's
        ``persisted`` lists those (name, version) pairs so the caller
        can reconcile — unlike the buffered path, which validates
        before writing anything.

        ``window_bytes="adaptive"`` sizes the window from the observed
        encode-rate/NIC-rate ratio: each flushed window's encode time
        retargets the next as ``W_next = W * encode_rate / client_bw``
        (clamped to ``ADAPTIVE_WINDOW_FLOOR``..``ADAPTIVE_WINDOW_CAP``)
        so the encoder stays exactly one window ahead of the NIC — a
        fast encoder gets big windows (less flush overhead), a slow one
        small windows (the NIC never starves).  Starts at the static
        8 MB ``DEFAULT_WINDOW_BYTES``, which is also the unconditional
        fallback when ``client_bw`` is unset (no NIC rate to target).
        The retarget trajectory is recorded in
        ``last_adaptive_windows``.

        Every object's xattr is stamped with a fresh monotonic
        ``version`` tag; the per-object versions are returned (in input
        order) so the writing client can keep its zone-map cache
        coherent without a read-back.
        """
        names = list(names)
        windowed = bool(window_bytes) or bool(window_objects)
        if xattrs is not None:
            xattrs = list(xattrs)
            if len(xattrs) != len(names):
                raise ValueError(f"{len(names)} names / "
                                 f"{len(xattrs)} xattrs")
        else:
            xattrs = [None] * len(names)
        # the write ledger pins each materialized blob (in-batch
        # failover may resend it) until its write AND replica chain
        # land, then releases it — a windowed stream retains O(window)
        ledger = _WriteLedger(len(names))
        blobs_l = ledger.blobs
        if not windowed:
            got = [b for b in blobs]
            if len(got) != len(names):
                raise ValueError(f"{len(names)} names / "
                                 f"{len(got)} blobs")
            for i, b in enumerate(got):
                ledger.pin(i, bytes(b))
        if not names:
            return []
        versions = [self._next_version() for _ in names]
        if windowed:
            stamped: list[dict | None] = [None] * len(names)
        else:
            stamped = [{**(x or {}), "version": v,
                        "digest": content_digest(b)}
                       for x, v, b in zip(xattrs, versions, blobs_l)]

        tried: list[set[str]] = [set() for _ in names]
        last_err: list[Exception | None] = [None] * len(names)
        use_pool = self.io_simulated()
        # server-side replication: one chain task per object, submitted
        # the moment that OBJECT's primary write lands (the ``landed``
        # hook), so replication fills disk-idle gaps of the NIC-paced
        # primary streams instead of queueing behind whole groups (the
        # pooled tasks are never waited on from inside a worker — no
        # deadlock); bare tuples are inline results
        rep_out: list[Any] = []

        def replicate(i: int, entry: str) -> tuple[int, int, float]:
            try:
                return self._replicate(names[i], blobs_l[i], stamped[i],
                                       self._acting(names[i]), entry)
            except OSDDown:  # peering/recovery restores it later
                return 0, 0, 0.0
            finally:
                # the write and its whole replica chain have landed:
                # no retry can ever resend this blob — release it (the
                # windowed stream's O(window) memory bound)
                ledger.release(i)

        def submit_replicas(i: int, entry: str) -> None:
            rep_out.append(self._pool.submit(replicate, i, entry)
                           if use_pool else replicate(i, entry))

        def drain_replicas() -> None:
            # the write acks only after its replicas landed; counters
            # accumulate HERE, on the caller's thread (worker threads
            # never touch the fabric — no lost-update hazard)
            for r in rep_out:
                moved, entry_moved, lat = r.result() if use_pool else r
                self.fabric.replica_bytes += moved
                self.fabric.entry_egress_bytes += entry_moved
                self.fabric.replica_lat_s += lat
            rep_out.clear()

        def write_group(osd_id: str,
                        idxs: list[int]) -> list[tuple[int, Any]]:
            done: set[int] = set()

            def landed(k: int) -> None:
                done.add(idxs[k])
                submit_replicas(idxs[k], osd_id)

            try:
                entry = self._osd(osd_id)
                # one framed request; the NIC stream (``_client_xfer``
                # per sub-write) keeps shared-NIC serialization per blob
                entry.put_batch(
                    [(names[i], blobs_l[i], stamped[i]) for i in idxs],
                    stream=self._client_xfer, landed=landed)
            except OSDDown as e:
                # sub-writes that landed before the failure keep their
                # success (their replication is already in flight); only
                # the unlanded remainder fails over — retrying a landed
                # item would double-count its NIC stream + replica bytes
                return [(i, None if i in done else e) for i in idxs]
            return [(i, None) for i in idxs]

        if windowed:
            try:
                pending = self._stream_put(
                    names, blobs, xattrs, versions, ledger, stamped,
                    tried, last_err, submit_replicas,
                    window_bytes=window_bytes,
                    window_objects=window_objects)
            except PartialWriteError:
                drain_replicas()  # landed sub-writes finish replicating
                self.last_put_ledger_peak_bytes = ledger.peak_bytes
                raise
        else:
            pending = list(range(len(names)))

        while pending:
            ordered = self._next_targets(pending, names, tried, last_err)
            outs = self._dispatch_groups(ordered, write_group)
            pending = []
            for (osd_id, idxs), pairs in zip(ordered, outs):
                self._account_request()  # one round trip per OSD group
                if isinstance(pairs, Exception):
                    # transient budget exhausted before ANY sub-write
                    # landed: the whole group fails over
                    for i in idxs:
                        tried[i].add(osd_id)
                        last_err[i] = pairs
                        pending.append(i)
                    continue
                for i, r in pairs:
                    tried[i].add(osd_id)
                    if isinstance(r, Exception):
                        last_err[i] = r
                        pending.append(i)
                        continue
                    self.fabric.client_tx += ledger.sizes[i]
            drain_replicas()
        drain_replicas()
        self.last_put_ledger_peak_bytes = ledger.peak_bytes
        return versions

    def _stream_put(self, names, blob_iter, xattrs, versions, ledger,
                    stamped, tried, last_err, submit_replicas, *,
                    window_bytes, window_objects) -> list[int]:
        """The windowed half of ``put_batch``: consume the (possibly
        still-encoding) blob producer, flush per-OSD sub-write groups
        into long-lived per-primary streaming requests as each window
        fills, and return the item indices that need buffered failover
        (their entry OSD died mid-stream).  Feeder queues are bounded,
        so a stalled stream back-pressures the encoder instead of
        buffering the whole batch; the write ledger releases each blob
        once it fully lands, so retained bytes stay O(window).  A
        producer length mismatch finalizes the started streams first,
        then raises :class:`PartialWriteError` naming every sub-write
        that already persisted (with its stamped version)."""
        blobs_l = ledger.blobs
        streams: dict[str, tuple[_queue.Queue, Any]] = {}

        def stream_group(osd_id: str, q: _queue.Queue) -> list:
            consumed: list[int] = []   # indices in consumption order
            done: set[int] = set()

            def landed(k: int) -> None:
                done.add(consumed[k])
                submit_replicas(consumed[k], osd_id)

            def feed():
                while True:
                    grp = q.get()
                    if grp is None:
                        return
                    for i in grp:
                        consumed.append(i)
                        yield (names[i], blobs_l[i], stamped[i])

            try:
                entry = self._osd(osd_id)
                entry.put_batch(feed(), stream=self._client_xfer,
                                landed=landed)
                return [(i, None) for i in consumed]
            except (OSDDown, TransientOSDError) as e:
                # keep draining so the (still-producing) client never
                # blocks on a dead stream's bounded queue; every
                # unlanded sub-write fails over
                out = [(i, None if i in done else e) for i in consumed]
                while True:
                    grp = q.get()
                    if grp is None:
                        return out
                    out.extend((i, e) for i in grp)

        # adaptive mode: start at the static default and retarget per
        # flushed window from the measured encode rate (see put_batch)
        adaptive = window_bytes == "adaptive"
        if adaptive:
            window_bytes = DEFAULT_WINDOW_BYTES
        trajectory: list[int] = []

        win: dict[str, list[int]] = {}
        win_nbytes = win_nobjs = 0
        enc_s = 0.0  # encode seconds spent on the CURRENT window

        def flush() -> None:
            nonlocal win_nbytes, win_nobjs, enc_s
            for osd_id, idxs in sorted(win.items()):
                if osd_id not in streams:
                    q: _queue.Queue = _queue.Queue(maxsize=8)
                    self._account_request()  # ONE request per stream
                    streams[osd_id] = (
                        q, self._pool.submit(stream_group, osd_id, q))
                streams[osd_id][0].put(idxs)
                self.fabric.stream_windows += 1
            win.clear()
            win_nbytes = win_nobjs = 0
            enc_s = 0.0

        def retarget() -> None:
            # keep the encoder exactly one window ahead: the next
            # window should take as long to ENCODE as this one takes
            # the NIC to DRAIN -> W_next = W * enc_rate / nic_rate
            nonlocal window_bytes
            if not (adaptive and self.client_bw and win_nbytes):
                return
            enc_rate = win_nbytes / max(enc_s, 1e-9)
            window_bytes = int(min(ADAPTIVE_WINDOW_CAP, max(
                ADAPTIVE_WINDOW_FLOOR,
                win_nbytes * enc_rate / self.client_bw)))
            trajectory.append(window_bytes)

        overlap = 0.0
        mismatch: str | None = None
        it = iter(blob_iter)
        try:
            for i in range(len(names)):
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    # the unflushed window is dropped (never streamed);
                    # flushed sub-writes persist and are reported below
                    mismatch = (f"{len(names)} names but the blob "
                                f"producer ended at {i}")
                    break
                dt = time.perf_counter() - t0
                if streams:  # encode time hidden behind an active stream
                    overlap += dt
                enc_s += dt
                blob, x = item if isinstance(item, tuple) \
                    else (item, xattrs[i])
                blob = bytes(blob)
                stamped[i] = {**(x or {}), "version": versions[i],
                              "digest": content_digest(blob)}
                ledger.pin(i, blob)
                win.setdefault(self._acting(names[i])[0], []).append(i)
                win_nbytes += len(blob)
                win_nobjs += 1
                if (window_bytes and win_nbytes >= window_bytes) or \
                        (window_objects and win_nobjs >= window_objects):
                    retarget()
                    flush()
            else:
                flush()
                try:  # mirror the buffered path's length validation: an
                    next(it)  # overlong producer is a caller bug, not
                except StopIteration:  # data to drop silently
                    pass
                else:
                    mismatch = (f"blob producer yielded more than "
                                f"{len(names)} items")
        finally:
            # sentinel every started stream even when the producer blew
            # up mid-encode — a stream left unterminated would park a
            # pool worker on its queue forever
            for q, _ in streams.values():
                q.put(None)

        failed: list[int] = []
        landed: list[int] = []
        for osd_id, (q, fut) in streams.items():
            for i, r in fut.result():
                tried[i].add(osd_id)
                if isinstance(r, Exception):
                    last_err[i] = r
                    failed.append(i)
                else:
                    self.fabric.client_tx += ledger.sizes[i]
                    landed.append(i)
        self.fabric.overlap_s += overlap
        if adaptive:
            self.last_adaptive_windows = tuple(trajectory)
        if mismatch is not None:
            landed.sort()
            raise PartialWriteError(
                f"{mismatch}; {len(landed)} sub-writes of the batch "
                "already persisted with stamped versions (listed in "
                ".persisted) — nothing else in the batch is durable",
                persisted=((names[i], versions[i]) for i in landed))
        return failed

    def _osd_call(self, fn, *args):
        """One request on a per-object CLIENT path, with the same
        transient retry budget as the batched planes.  Runs on the
        caller's thread, so retries accrue to ``Fabric.retries``
        directly; an exhausted budget re-raises (terminal for that
        replica — the caller's failover loop moves on)."""
        t0 = time.perf_counter()
        attempt = 0
        boff = self.retry.backoff(salt=next(self._salt))
        while True:
            try:
                return fn(*args)
            except TransientOSDError:
                if self.retry.give_up(attempt, t0):
                    raise
                time.sleep(boff.next_s())
                self.fabric.retries += 1
                attempt += 1

    def _osd_call_quiet(self, fn, *args):
        """Transient-retry twin of ``_osd_call`` for MAINTENANCE-daemon
        paths: same backoff budget, but it touches no fabric counter —
        ``Fabric.retries`` is client-owned (caller-thread-only
        accounting), so a daemon retry must never ``+=`` it from a
        background thread while a client thread is doing the same."""
        t0 = time.perf_counter()
        attempt = 0
        boff = self.retry.backoff(salt=next(self._salt))
        while True:
            try:
                return fn(*args)
            except TransientOSDError:
                if self.retry.give_up(attempt, t0):
                    raise
                time.sleep(boff.next_s())
                attempt += 1

    def get(self, name: str) -> bytes:
        """Read from the primary, failing over down the acting set.
        The served copy is digest-verified on its OSD; a divergent copy
        is quarantined there and the read fails over like a miss."""
        return self.get_with_version(name)[0]

    def get_with_version(self, name: str) -> tuple[bytes, int]:
        """``get`` that also returns the copy's stamped xattr
        ``version`` tag from the SAME round trip (-1 when the copy has
        no version xattr) — how a client learns an object's version
        without a separate ``xattr_ops`` lookup."""
        err: Exception | None = None
        for osd_id in self._acting(name):
            try:
                osd = self._osd(osd_id)
                blob = self._osd_call(osd.get, name)
                with osd.lock:
                    version = int((osd.xattrs.get(name) or {})
                                  .get("version", -1))
                self.fabric.client_rx += len(blob)
                self.fabric.rx_frames += 1
                self._account_request()
                self._client_xfer(len(blob))
                return blob, version
            except CorruptObject as e:  # quarantined on its OSD
                self.fabric.corruptions_detected += 1
                self._account_request()  # the request DID round-trip
                err = e
            except (OSDDown, ObjectNotFound, TransientOSDError) as e:
                err = e
        if isinstance(err, CorruptObject):
            raise DataLossError(
                [name], f"{name}: every replica lost or corrupt "
                        f"(last: {err})",
                census=self.copy_census([name]))
        raise err if err else ObjectNotFound(name)

    def get_hedged(self, name: str, timeout_s: float) -> bytes:
        """Hedged read (straggler mitigation): fire the primary, and if it
        does not answer within ``timeout_s``, race a replica.

        Uses the store's persistent executor (no pool churn, no leaked
        straggler thread — the worker is reclaimed when the straggler
        returns) and pays the same NIC accounting as every other read.
        """
        acting = self._acting(name)
        if len(acting) == 1:
            return self.get(name)
        fut = self._hedge_pool.submit(self._osd(acting[0]).get, name)
        try:
            blob = fut.result(timeout=timeout_s)
        except Exception:
            blob = None
            for osd_id in acting[1:]:  # hedge down the acting set
                try:
                    blob = self._osd(osd_id).get(name)
                    self._account_request()  # extra round trip
                    break
                except CorruptObject:
                    self.fabric.corruptions_detected += 1
                    self._account_request()
                    continue
                except (OSDDown, ObjectNotFound, TransientOSDError):
                    continue
            if blob is None:
                # no replica could serve: the slow primary is still the
                # best (only) hope — wait it out like a plain get()
                blob = fut.result()
        self.fabric.client_rx += len(blob)
        self.fabric.rx_frames += 1
        self._account_request()
        self._client_xfer(len(blob))
        return blob

    def exec(self, name: str, ops: list[ObjOp]) -> Any:
        """Execute an objclass pipeline ON the object's primary OSD and
        return only the result — the pushdown path.  Only the result size
        crosses the client<->storage fabric."""
        err: Exception | None = None
        for osd_id in self._acting(name):
            try:
                osd = self._osd(osd_id)
                result, scanned = self._osd_call(osd.exec_cls, name, ops)
                rx = _result_nbytes(result)
                self.fabric.local_bytes += scanned
                self.fabric.client_rx += rx
                self.fabric.rx_frames += 1
                self._account_request()
                self._client_xfer(rx)
                return result
            except CorruptObject as e:  # quarantined: fail over
                self.fabric.corruptions_detected += 1
                self._account_request()
                err = e
            except (OSDDown, ObjectNotFound, TransientOSDError) as e:
                err = e
        if isinstance(err, CorruptObject):
            raise DataLossError(
                [name], f"{name}: every replica lost or corrupt "
                        f"(last: {err})",
                census=self.copy_census([name]))
        raise err if err else ObjectNotFound(name)

    def exec_batch(self, names: Iterable[str],
                   ops: list[ObjOp] | Sequence[list[ObjOp]]) -> list[Any]:
        """Batched objclass execution: ONE request per involved OSD.

        Objects are grouped by their primary OSD and each group goes out
        as a single ``exec_cls_batch`` round trip, so ``Fabric.ops``
        grows with the number of OSDs touched, not the number of
        objects.  ``ops`` is either one pipeline applied to every object
        or a per-object sequence of pipelines (``len == len(names)``).

        Failover: objects whose request failed (OSD down, replica
        missing the object) are re-grouped onto their next untried
        replica and retried as fresh batched requests; per-object
        results are returned in input order, bit-identical to the
        per-object ``exec`` path.
        """
        gen, results = self._exec_batch_impl(names, ops)
        for _ in gen:
            pass
        return results

    def exec_batch_iter(self, names: Iterable[str],
                        ops: list[ObjOp] | Sequence[list[ObjOp]]
                        ) -> Iterator[tuple[int, Any]]:
        """Streaming twin of ``exec_batch``: yields ``(index, result)``
        pairs the moment their per-OSD group response lands (completion
        order), so the consumer decodes early results while slower OSDs
        are still scanning.  Same requests, failover, and accounting as
        the buffered form; delivered results count in
        ``Fabric.stream_windows``."""
        gen, _ = self._exec_batch_impl(names, ops, stream=True)
        return gen

    def _exec_batch_impl(self, names, ops, stream: bool = False):
        names = list(names)
        results: list[Any] = [None] * len(names)
        if not names:
            return iter(()), results
        if ops and isinstance(ops[0], (list, tuple)):
            pipelines = [list(p) for p in ops]
            if len(pipelines) != len(names):
                raise ValueError(
                    f"{len(pipelines)} pipelines for {len(names)} objects")
        else:
            pipelines = [list(ops)] * len(names)

        def run_group(osd_id: str, idxs: list[int]) -> Any:
            try:
                osd = self._osd(osd_id)
                return osd.exec_cls_batch(
                    [(names[i], pipelines[i]) for i in idxs])
            except OSDDown as e:  # whole request failed
                return e

        def handle(idxs, got, last_err):
            got, meters = got
            self._apply_meters(meters)
            group_rx = 0
            retry = []
            emitted = []
            for i, r in zip(idxs, got):
                if isinstance(r, Exception):  # per-item miss on this OSD
                    if isinstance(r, CorruptObject):
                        self.fabric.corruptions_detected += 1
                    last_err[i] = r
                    retry.append(i)
                    continue
                result, scanned = r
                self.fabric.local_bytes += scanned
                group_rx += _result_nbytes(result)
                self.fabric.rx_frames += 1
                results[i] = result
                emitted.append((i, result))
            self.fabric.client_rx += group_rx
            self._client_xfer(group_rx)
            return retry, emitted

        gen = self._scatter_iter(names, run_group, handle, stream=stream)
        return gen, results

    def exec_combine(self, names: Iterable[str], ops: list[ObjOp],
                     prune=None) -> Any:
        """Batched pushdown with SERVER-SIDE combine.

        Each involved OSD runs the (shared, decomposable) pipeline over
        its local objects, folds the per-object partials with the tail
        op's associative ``merge``, and returns ONE partial — so an
        N-object aggregate scan over K OSDs moves K partials
        (``client_rx`` O(K)) in K round trips, instead of N partials in
        K round trips (``exec_batch``) or N in N (per-object ``exec``).

        Objects missing from an OSD fail over to the next replica in
        their acting set exactly like ``exec_batch``.  Returns one
        merged partial per issued request that found at least one
        object; finish with ``objclass.combine_partials`` (merged
        partials are shape-identical to raw ones).

        ``prune`` pushes a filter-expression tree (an ``expr.Expr`` —
        OR-groups, IN-lists, ranges, prefixes — its wire dict, or the
        legacy tuple of (col, cmp, value) triples) down with each
        request, serialized by ``_prune_wire``: the OSD skips objects
        whose CURRENT local zone map proves the expression matches
        nothing, and the call returns ``(partials, pruned_names)``
        instead of the bare partial list.  Pruned objects are a
        semantic skip — they are NOT retried on replicas.
        """
        gen, pruned_out = self._exec_combine_impl(names, ops, prune)
        partials = list(gen)
        return (partials, pruned_out) if prune is not None else partials

    def exec_combine_iter(self, names: Iterable[str], ops: list[ObjOp],
                          prune=None, pruned_out: list | None = None
                          ) -> Iterator[Any]:
        """Streaming twin of ``exec_combine``: yields each OSD's merged
        partial as the scatter progresses.  Partials are scalar-sized
        (there is no decode to overlap), so delivery keeps DISPATCH
        order — a float fold over the yields is bit-deterministic run
        to run, unlike a completion-order stream.  OSD-pruned names
        accumulate into ``pruned_out`` (complete once the iterator is
        exhausted)."""
        gen, _ = self._exec_combine_impl(names, ops, prune, stream=True,
                                         pruned_out=pruned_out)
        return gen

    def _exec_combine_impl(self, names, ops, prune, stream: bool = False,
                           pruned_out: list | None = None):
        names = list(names)
        out_pruned: list[str] = pruned_out if pruned_out is not None \
            else []
        if not names:
            return iter(()), out_pruned
        ops = list(ops)
        if not pipeline_mergeable(ops):
            raise ValueError("exec_combine needs a decomposable pipeline "
                             "whose tail has an associative merge")
        wire = _prune_wire(prune)

        def run_group(osd_id: str, idxs: list[int]) -> Any:
            try:
                osd = self._osd(osd_id)
                return osd.exec_cls_batch(
                    [(names[i], ops) for i in idxs], combine=True,
                    prune=wire)
            except OSDDown as e:
                return e

        def handle(idxs, got, last_err):
            merged, _, scanned, missing, pruned, corrupt, meters = got
            self._apply_meters(meters)
            self.fabric.local_bytes += scanned
            self.fabric.corruptions_detected += len(corrupt)
            emitted = []
            if merged is not None:
                rx = _result_nbytes(merged)
                self.fabric.client_rx += rx
                self.fabric.rx_frames += 1
                self._client_xfer(rx)
                emitted.append(merged)
            out_pruned.extend(pruned)
            miss, bad = set(missing), set(corrupt)
            retry = [i for i in idxs if names[i] in miss | bad]
            for i in retry:
                last_err[i] = CorruptObject(names[i]) \
                    if names[i] in bad else ObjectNotFound(names[i])
            return retry, emitted

        # dispatch order even when streaming: merged partials are a few
        # bytes each, so there is no decode to overlap — but the fold
        # over them is float-order-sensitive and must stay deterministic
        gen = self._scatter_iter(names, run_group, handle, stream=stream,
                                 completion_order=False)
        return gen, out_pruned

    def exec_concat(self, names: Iterable[str],
                    ops: list[ObjOp] | Sequence[list[ObjOp]],
                    prune=None) -> tuple[list, list[str]]:
        """Batched pushdown with SERVER-SIDE table concat — the
        table-out twin of ``exec_combine``.

        Each involved OSD runs its items' (table-out) pipelines over
        local data, concatenates the per-object result tables, and
        returns ONE encoded block per request — a filter→project scan
        over N objects on K OSDs moves exactly K framed responses
        (``rx_frames`` O(K)) instead of N.  ``ops`` is one shared
        pipeline or a per-object sequence (``len == len(names)``),
        mirroring ``exec_batch``.

        Returns ``(frames, pruned_names)`` where each frame is
        ``(input_indices, blob, row_counts)``: the indices (into
        ``names``) this frame serves, in the order their rows appear in
        the concatenated block, with ``row_counts[j]`` rows belonging
        to ``indices[j]`` — everything the client needs to re-slice the
        block into per-object tables and restore global row order.
        ``prune`` behaves exactly as in ``exec_combine`` (OSD-side
        zone-map skip against current xattrs, no replica retry).
        Missing objects fail over to the next replica as fresh batched
        requests.
        """
        gen, pruned_out = self._exec_concat_impl(names, ops, prune)
        return list(gen), pruned_out

    def exec_concat_iter(self, names: Iterable[str],
                         ops: list[ObjOp] | Sequence[list[ObjOp]],
                         prune=None, pruned_out: list | None = None
                         ) -> Iterator[tuple]:
        """Streaming twin of ``exec_concat``: yields each OSD's framed
        block ``(input_indices, blob, row_counts)`` the moment its
        response lands (completion order), so the client decodes early
        frames while slower OSDs are still scanning — the scan-side
        half of the windowed overlap (delivered frames count in
        ``Fabric.stream_windows``).  OSD-pruned names accumulate into
        ``pruned_out`` (complete once the iterator is exhausted)."""
        gen, _ = self._exec_concat_impl(names, ops, prune, stream=True,
                                        pruned_out=pruned_out)
        return gen

    def _exec_concat_impl(self, names, ops, prune, stream: bool = False,
                          pruned_out: list | None = None):
        names = list(names)
        out_pruned: list[str] = pruned_out if pruned_out is not None \
            else []
        if not names:
            return iter(()), out_pruned
        if ops and isinstance(ops[0], (list, tuple)):
            pipelines = [list(p) for p in ops]
            if len(pipelines) != len(names):
                raise ValueError(
                    f"{len(pipelines)} pipelines for {len(names)} objects")
        else:
            pipelines = [list(ops)] * len(names)

        wire = _prune_wire(prune)

        def run_group(osd_id: str, idxs: list[int]) -> Any:
            try:
                osd = self._osd(osd_id)
                return osd.exec_cls_batch(
                    [(names[i], pipelines[i]) for i in idxs],
                    concat=True, prune=wire)
            except OSDDown as e:
                return e

        def handle(idxs, got, last_err):
            (blob, served, counts, scanned, missing, pruned, corrupt,
             meters) = got
            self._apply_meters(meters)
            self.fabric.local_bytes += scanned
            self.fabric.corruptions_detected += len(corrupt)
            emitted = []
            if blob is not None:
                self.fabric.client_rx += len(blob)
                self.fabric.rx_frames += 1
                self._client_xfer(len(blob))
                emitted.append(
                    (tuple(idxs[k] for k in served), blob, counts))
            out_pruned.extend(pruned)
            miss, bad = set(missing), set(corrupt)
            retry = [i for i in idxs if names[i] in miss | bad]
            for i in retry:
                last_err[i] = CorruptObject(names[i]) \
                    if names[i] in bad else ObjectNotFound(names[i])
            return retry, emitted

        gen = self._scatter_iter(names, run_group, handle, stream=stream)
        return gen, out_pruned

    def delete(self, name: str) -> None:
        for osd_id in self.cluster.up_osds:
            osd = self.osds[osd_id]
            with osd.lock:
                osd.data.pop(name, None)
                osd.xattrs.pop(name, None)
            osd.cache.invalidate(name)

    def exists(self, name: str) -> bool:
        for o in self.cluster.up_osds:
            osd = self.osds[o]
            with osd.lock:  # writers mutate osd.data concurrently
                if name in osd.data:
                    return True
        return False

    def list_objects(self, prefix: str = "") -> list[str]:
        seen: set[str] = set()
        for o in self.cluster.up_osds:
            seen |= {n for n in self.osds[o].object_names()
                     if n.startswith(prefix)}
        return sorted(seen)

    def xattr(self, name: str) -> dict:
        """Metadata lookup (one round trip, counted in ``xattr_ops`` —
        clients should cache zone maps per cluster epoch, see
        ``GlobalVOL``)."""
        self.fabric.xattr_ops += 1
        for osd_id in self._acting(name):
            osd = self.osds[osd_id]
            with osd.lock:  # writers mutate osd.xattrs concurrently
                if name in osd.xattrs:
                    return dict(osd.xattrs[name])
        return {}

    def list_zone_maps(self, names: Iterable[str]) -> dict[str, dict]:
        """Batched metadata plane: many objects' xattrs (zone map +
        version) in ONE ``OSD.list_xattrs`` request per primary OSD, so
        warming a client's zone-map cache over N objects costs K
        ``xattr_ops`` instead of N.  Names whose target OSD is down or
        lacks the xattr fail over down the acting set; names found
        nowhere are simply absent from the result (mirroring ``xattr``
        returning {})."""
        names = list(dict.fromkeys(names))
        if not names:
            return {}
        out: dict[str, dict] = {}
        tried: list[set[str]] = [set() for _ in names]
        pending = list(range(len(names)))

        def fetch_group(osd_id: str, idxs: list[int]) -> Any:
            try:
                return self._osd(osd_id).list_xattrs(
                    [names[i] for i in idxs])
            except OSDDown as e:
                return e

        while pending:
            skipped: list[int] = []
            ordered = self._next_targets(pending, names, tried,
                                         skipped=skipped)
            outs = self._dispatch_groups(ordered, fetch_group)
            pending = []
            for (osd_id, idxs), got in zip(ordered, outs):
                self.fabric.xattr_ops += 1  # one lookup per OSD request
                for i in idxs:
                    tried[i].add(osd_id)
                    if isinstance(got, Exception) or names[i] not in got:
                        pending.append(i)  # retry on the next replica
                    else:
                        out[names[i]] = got[names[i]]
        return out

    # ------------------------------------------------------------ failures
    def fail_osd(self, osd_id: str) -> None:
        """Disk loss: data gone, OSD marked down, epoch bumped."""
        old = self.cluster
        self.cluster = old.mark_down(osd_id)
        self.osds[osd_id] = OSD(  # data destroyed (cache with it)
            osd_id, self.disk_bw, scan_bw=self.scan_bw,
            cache_bytes=self.cache_bytes)
        if self.faults is not None:  # keep the injector wired to the
            self.faults.attach_osd(self.osds[osd_id])  # replacement OSD
        if self.maintenance is not None:  # wake the live rebalancer
            self.maintenance.note_topology_change()

    def add_osds(self, ids: Iterable[str]) -> None:
        ids = list(ids)
        self.cluster = self.cluster.add_osds(ids)
        for i in ids:
            self.osds[i] = OSD(i, self.disk_bw, scan_bw=self.scan_bw,
                               cache_bytes=self.cache_bytes)
            if self.faults is not None:
                self.faults.attach_osd(self.osds[i])
        if self.maintenance is not None:
            self.maintenance.note_topology_change()

    # ------------------------------------------------------------ scrub/heal
    def _verified_copies(self, name: str) -> tuple[list, list, list]:
        """Classify every up-OSD copy of one object WITHOUT serving it:
        ``(verified, divergent, undigested)``.  ``verified`` holds
        ``(version, osd_id, blob, xattr)`` tuples whose stored bytes
        match their stamped digest; ``divergent`` holds copies that
        fail their own digest OR lost their xattr (torn write) while a
        digested copy exists elsewhere; ``undigested`` holds copies
        with no digest to check (legacy/native writes) — unverifiable,
        not provably corrupt."""
        verified, divergent, bare = [], [], []
        for osd_id in self.cluster.up_osds:
            osd = self.osds[osd_id]
            with osd.lock:
                blob = osd.data.get(name)
                xattr = dict(osd.xattrs.get(name) or {})
            if blob is None:
                continue
            digest = xattr.get("digest")
            if digest is None:
                bare.append((osd_id, blob, xattr))
            elif content_digest(blob) == int(digest):
                verified.append((int(xattr.get("version", -1)),
                                 osd_id, blob, xattr))
            else:
                divergent.append((osd_id, blob, xattr))
        if verified or any(x for _, _, x in bare):
            # torn copies (blob, no xattr at all) are divergent once any
            # OTHER copy proves the object should carry metadata
            torn = [(o, b, x) for o, b, x in bare if not x]
            bare = [(o, b, x) for o, b, x in bare if x]
            divergent.extend(torn)
        verified.sort(key=lambda t: -t[0])  # newest version first
        return verified, divergent, bare

    def _quarantined_on(self, name: str) -> list[str]:
        """Up OSDs holding a quarantined copy of ``name`` — snapshotted
        under each OSD's lock (read paths quarantine concurrently)."""
        out = []
        for osd_id in self.cluster.up_osds:
            osd = self.osds[osd_id]
            with osd.lock:
                held = name in osd.quarantine
            if held:
                out.append(osd_id)
        return out

    def _quarantined_names(self) -> set[str]:
        """Every quarantined name across the up OSDs (same snapshot
        discipline) — the scrub/recover inventory extension."""
        names: set[str] = set()
        for osd_id in self.cluster.up_osds:
            osd = self.osds[osd_id]
            with osd.lock:
                names |= set(osd.quarantine)
        return names

    def scrub(self, heal: bool = True) -> dict:
        """Background integrity pass (the maintenance half of the
        self-healing plane): walk every up OSD, digest-verify each
        local copy, quarantine divergent/torn ones, and — with
        ``heal=True`` — restore every acting-set copy from the
        highest-version verified source through the replication chain
        (``_replicate``; bytes accrue to ``Fabric.recovery_bytes``,
        copies to ``Fabric.heals``).

        Idempotent: a second scrub right after a healing one finds
        nothing (all copies verified, quarantine is out of service).
        Returns stats: bytes verified, corruptions found, copies
        healed, plus the names it could not help — ``lost`` (had a
        digest somewhere but NO verified copy survives) and
        ``undigested`` (legacy objects with no digest to check; never
        touched).  Scrub is a maintenance client: its verify reads are
        OSD-local (counted in ``Fabric.scrub_bytes``, not client
        traffic), and only heal traffic crosses the OSD fabric."""
        inventory = set(self.list_objects()) | self._quarantined_names()
        found = healed = 0
        lost: list[str] = []
        undigested: list[str] = []
        for name in sorted(inventory):
            step = self._scrub_object(name, heal=heal)
            found += step["corrupt"]
            healed += step["healed"]
            if step["lost"]:
                lost.append(name)  # digested object, no good copy
            elif step["undigested"]:
                undigested.append(name)  # legacy: nothing to check
        return {"objects_scrubbed": len(inventory),
                "corrupt_copies": found, "healed_copies": healed,
                "lost": tuple(lost), "undigested": tuple(undigested),
                "epoch": self.cluster.epoch}

    def _scrub_object(self, name: str, heal: bool = True) -> dict:
        """One object's scrub step — the unit both on-demand ``scrub()``
        and the maintenance plane's continuous walker iterate: classify
        every copy (``_verified_copies``), quarantine divergent/torn
        ones, and heal missing acting-set copies from the best verified
        source through the replication chain.  Returns ``{"bytes":
        verified bytes (the walker's rate-limit currency), "corrupt":
        copies quarantined, "healed": copies restored, "lost"/
        "undigested": flags}``."""
        out = {"bytes": 0, "corrupt": 0, "healed": 0,
               "lost": False, "undigested": False}
        verified, divergent, bare = self._verified_copies(name)
        for _, _, blob, _ in verified:
            out["bytes"] += len(blob)
            self.fabric.scrub_bytes += len(blob)
        for osd_id, blob, _ in divergent:
            out["bytes"] += len(blob)
            self.fabric.scrub_bytes += len(blob)
            self.osds[osd_id]._quarantine_copy(name)
            self.fabric.corruptions_detected += 1
            out["corrupt"] += 1
        if not verified:
            if divergent or self._quarantined_on(name):
                out["lost"] = True
            elif bare:
                out["undigested"] = True
            return out
        if not heal:
            return out
        _, src, blob, xattr = verified[0]
        holders = {osd_id for _, osd_id, _, _ in verified}
        targets = [o for o in self._acting(name) if o not in holders]
        if not targets:
            return out
        moved, _, _ = self._replicate(name, blob, xattr,
                                      [src] + targets, entry=src)
        copies = moved // len(blob) if blob else len(targets)
        self.fabric.recovery_bytes += moved
        self.fabric.heals += copies
        out["healed"] = copies
        return out

    def copy_census(self, names: Iterable[str]
                    ) -> dict[str, dict[str, list[str]]]:
        """Per-object copy census for operator triage: which up OSDs
        hold a digest-``verified`` copy, a ``divergent`` one (fails its
        own digest), a ``bare`` unverifiable one (no digest stamped),
        and which hold a ``quarantined`` copy pulled from service.
        Rides on every :class:`DataLossError` so the choice to
        ``recover(allow_loss=True)`` is an informed one.  OSD-local
        inspection only — no fabric traffic is charged."""
        out: dict[str, dict[str, list[str]]] = {}
        for name in dict.fromkeys(names):
            verified, divergent, bare = self._verified_copies(name)
            out[name] = {
                "verified": [o for _, o, _, _ in verified],
                "divergent": [o for o, _, _ in divergent],
                "bare": [o for o, _, _ in bare],
                "quarantined": self._quarantined_on(name),
            }
        return out

    def recover(self, old_map: ClusterMap | None = None, *,
                expected: Iterable[str] | None = None,
                allow_loss: bool = False) -> dict:
        """Peering: for every object, ensure each OSD in the (new)
        acting set holds a copy, sourcing from a DIGEST-VERIFIED
        surviving replica — a corrupt copy is never propagated; it is
        quarantined and the source search falls down the remaining
        copies (undigested legacy copies are used only when no digested
        copy exists).  Runs after fail_osd/add_osds.

        An object with no usable copy left is DATA LOSS and raises
        :class:`DataLossError` naming the objects — pass
        ``allow_loss=True`` to get the legacy stats-only behavior
        (the lost names still ride in the returned dict).  ``expected``
        extends the inventory with names the caller knows should exist
        (e.g. from an ObjectMap), so even objects whose every replica
        vanished — invisible to ``list_objects`` — are detected."""
        inventory = set(self.list_objects()) | self._quarantined_names()
        if expected is not None:
            inventory |= set(expected)
        moved = 0
        lost: list[str] = []
        for name in sorted(inventory):
            acting = self._acting(name)
            verified, divergent, bare = self._verified_copies(name)
            for osd_id, _, _ in divergent:  # refuse corrupt sources
                self.osds[osd_id]._quarantine_copy(name)
                self.fabric.corruptions_detected += 1
            if verified:
                _, _, src_blob, src_xattr = verified[0]
            elif bare:  # unverifiable legacy copy beats nothing
                _, src_blob, src_xattr = bare[0]
            else:
                lost.append(name)  # all replicas lost (over-failure)
                continue
            for osd_id in acting:
                osd = self._osd(osd_id)
                with osd.lock:  # writers land copies concurrently
                    held = name in osd.data
                if not held:
                    try:
                        self._hop_put(osd_id, name, src_blob, src_xattr)
                    except (OSDDown, TransientOSDError):
                        continue  # next peering pass heals it
                    self.fabric.recovery_bytes += len(src_blob)
                    self.fabric.heals += 1
                    moved += 1
        if lost and not allow_loss:
            raise DataLossError(
                lost, f"recover(): {len(lost)} object(s) have no "
                      f"surviving verified replica: {lost[:8]}"
                      f"{'...' if len(lost) > 8 else ''}",
                census=self.copy_census(lost))
        return {"objects_moved": moved, "objects_lost": len(lost),
                "lost": tuple(lost), "epoch": self.cluster.epoch}

    # ------------------------------------------------------ maintenance ops
    # primitives the background MaintenancePlane (core.maintenance)
    # drives: each runs on the calling daemon thread — OSD-local work
    # plus OSD->OSD traffic, never client fabric bytes — and eagerly
    # invalidates cached forms (result cache + negative entries) of
    # every object it rewrites, so the serve plane can never answer
    # from a pre-rewrite entry.

    def invalidate_cached(self, name: str) -> None:
        """Drop every up OSD's cached forms of one object — positive
        result-cache entries AND negative (nothing-to-serve) entries
        share the per-name index, so one call retires both."""
        for osd_id in self.cluster.up_osds:
            self.osds[osd_id].cache.invalidate(name)

    def _maint_put(self, name: str, blob: bytes,
                   xattr: dict | None = None) -> tuple[int, int]:
        """Maintenance-plane write: stamp a fresh version + digest and
        land the object on its acting set (entry + replica chain), like
        ``put`` but WITHOUT client fabric accounting — the bytes are
        cluster-internal.  Returns ``(version, bytes_moved)``."""
        version = self._next_version()
        stamped = {**(xattr or {}), "version": version,
                   "digest": content_digest(blob)}
        acting = self._acting(name)
        self._hop_put(acting[0], name, blob, stamped)
        moved, _, _ = self._replicate(name, blob, stamped, acting)
        self.invalidate_cached(name)
        return version, len(blob) + moved

    def compact_run(self, names: Sequence[str], out_name: str,
                    rows: tuple[int, int] | None = None
                    ) -> tuple[int, int]:
        """Fold one run of small objects into ``out_name``: gather each
        member's best digest-verified copy, ship the run to the merge
        OSD (``out_name``'s primary) where the ``compact_merge``
        objclass op concatenates and re-encodes it, then replicate the
        merged object down its acting set.  ``rows`` stamps the merged
        object's GLOBAL row extent so pushed-down ``row_slice`` ops
        resolve against it exactly as they did against the members.
        Returns ``(version, bytes)`` — bytes include member gathers,
        the merge write, and replication (``Fabric.compaction_bytes``).
        The members are NOT deleted here: the caller (the maintenance
        plane) retires them through versioned GC after its retention
        window, so in-flight scans still find them until every compiled
        plan has refreshed onto the new map."""
        blobs: list[bytes] = []
        gathered = 0
        for member in names:
            verified, _, bare = self._verified_copies(member)
            if verified:
                blobs.append(verified[0][2])
            elif bare:
                blobs.append(bare[0][1])
            else:
                raise DataLossError(
                    [member], f"compact_run: no usable copy of {member}",
                    census=self.copy_census([member]))
            gathered += len(blobs[-1])
        version = self._next_version()
        xattr: dict = {"version": version}
        if rows is not None:
            xattr["rows"] = [int(rows[0]), int(rows[1])]
        acting = self._acting(out_name)
        entry = self._osd(acting[0])
        blob, stamped = self._osd_call_quiet(
            entry.compact_merge, blobs, out_name, xattr)
        moved, _, _ = self._replicate(out_name, blob, stamped, acting)
        self.invalidate_cached(out_name)
        nbytes = gathered + len(blob) + moved
        self.fabric.compactions += 1
        self.fabric.compaction_bytes += nbytes
        return version, nbytes

    def rebalance_object(self, name: str) -> int:
        """Move one object toward its CURRENT placement: copy the best
        verified source onto every acting OSD that lacks a copy, then —
        only once EVERY acting copy digest-verifies — drop stray copies
        parked on non-acting OSDs.  A failed hop or unverified acting
        copy keeps the strays (they are still the safety margin), so a
        crash mid-step never reduces the number of good copies.
        Divergent copies are left for the scrub walker to quarantine —
        the walker owns corruption accounting.  Returns bytes moved
        (``Fabric.rebalance_bytes``)."""
        acting = self._acting(name)
        verified, divergent, bare = self._verified_copies(name)
        if not verified and not bare:
            return 0
        if verified:
            _, _, blob, xattr = verified[0]
        else:
            _, blob, xattr = bare[0]
        # divergent copies count as holders too: overwriting one would
        # silently repair it and rob the walker of the detection
        holders = {o for _, o, _, _ in verified} | \
            {o for o, _, _ in bare} | {o for o, _, _ in divergent}
        moved = 0
        for osd_id in acting:
            if osd_id in holders:
                continue
            try:
                self._hop_put(osd_id, name, blob, xattr)
            except (OSDDown, TransientOSDError):
                continue  # next pass finishes the move
            moved += len(blob)
        # verify-before-drop: every acting copy must check out
        digest = (xattr or {}).get("digest")
        for osd_id in acting:
            osd = self.osds[osd_id]
            with osd.lock:
                copy = osd.data.get(name)
                have = (osd.xattrs.get(name) or {}).get("digest")
            if copy is None:
                return moved  # move incomplete: keep the strays
            if digest is not None and (
                    have is None or content_digest(copy) != int(have)):
                return moved
        for osd_id in self.cluster.up_osds:
            if osd_id in acting:
                continue
            osd = self.osds[osd_id]
            with osd.lock:
                stray = osd.data.pop(name, None)
                osd.xattrs.pop(name, None)
            if stray is not None:
                osd.cache.invalidate(name)
        if moved:
            self.invalidate_cached(name)
            self.fabric.rebalance_bytes += moved
        return moved

    def purge_quarantined(self, name: str) -> int:
        """Release every quarantined copy of one object (versioned GC,
        after the retention window).  Returns bytes freed."""
        freed = 0
        for osd_id in self.cluster.up_osds:
            osd = self.osds[osd_id]
            with osd.lock:
                entry = osd.quarantine.pop(name, None)
            if entry is not None:
                freed += len(entry[0])
        return freed

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "fabric": self.fabric.snapshot(),
            "epoch": self.cluster.epoch,
            "osd_bytes": {o: self.osds[o].nbytes()
                          for o in self.cluster.osds},
            "n_objects": len(self.list_objects()),
            "cache_resident_bytes": {
                o: self.osds[o].cache.resident_bytes
                for o in self.cluster.osds},
        }

    # ------------------------------------------------------------ state
    def export_state(self) -> dict:
        """The store's contents as plain Python data: the cluster map's
        fields, each OSD's objects and xattrs, and the write clock —
        what :meth:`from_state` rebuilds a store from.  Quarantined
        copies and caches are not part of it."""
        c = self.cluster
        osds = {}
        for osd_id, osd in self.osds.items():
            with osd.lock:
                osds[osd_id] = {"data": dict(osd.data),
                                "xattrs": copy.deepcopy(osd.xattrs)}
        with self._lock:
            vclock = self._vclock
        return {"cluster": {"osds": list(c.osds), "n_pgs": c.n_pgs,
                            "replicas": c.replicas, "epoch": c.epoch,
                            "weights": dict(c.weights),
                            "down": sorted(c.down)},
                "osds": osds, "vclock": vclock}

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "ObjectStore":
        """A store holding ``state`` (as :meth:`export_state` gives it);
        ``kwargs`` are the constructor's serve/IO settings."""
        c = state["cluster"]
        cm = ClusterMap(tuple(c["osds"]), n_pgs=int(c["n_pgs"]),
                        replicas=int(c["replicas"]), epoch=int(c["epoch"]),
                        weights=dict(c["weights"]),
                        down=frozenset(c["down"]))
        store = cls(cm, **kwargs)
        for osd_id, s in state["osds"].items():
            osd = store.osds[osd_id]
            with osd.lock:
                osd.data.update((k, bytes(v)) for k, v in s["data"].items())
                osd.xattrs.update(copy.deepcopy(s["xattrs"]))
        with store._lock:
            store._vclock = int(state["vclock"])
        return store


def _prune_wire(prune):
    """Client half of the predicate transport: normalize an Expr (or
    legacy triples) to the serialized tree dict that rides inside the
    batched request — the OSD parses it back with ``expr.from_json``.

    The tree is run through ``expr.normalize`` first (De Morgan
    push-down, constant folding, same-column interval merging): the
    prune payload only ever drives zone-map *interval* decisions over
    scalar metadata, exactly the domain where the rewrite makes more
    trees prunable — evaluation filters inside pipelines are never
    normalized, so row semantics are untouched."""
    pred = ex.normalize(ex.ensure_pred(prune))
    return None if pred is None else pred.to_json()


def _result_nbytes(result: Any) -> int:
    if isinstance(result, (bytes, bytearray)):
        return len(result)
    if isinstance(result, dict):
        return sum(np.asarray(v).nbytes for v in result.values())
    return 64  # scalar-ish


def make_store(n_osds: int, *, replicas: int = 3, n_pgs: int = 128,
               prefix: str = "osd", client_bw: float | None = None,
               disk_bw: float | None = None,
               scan_bw: float | None = None,
               cache_bytes: int = 0,
               replication: str = "chain",
               hop_latency_s: float = 0.0,
               retry: RetryPolicy | None = None) -> ObjectStore:
    cm = ClusterMap(tuple(f"{prefix}.{i}" for i in range(n_osds)),
                    n_pgs=n_pgs, replicas=min(replicas, n_osds))
    return ObjectStore(cm, client_bw=client_bw, disk_bw=disk_bw,
                       scan_bw=scan_bw, cache_bytes=cache_bytes,
                       replication=replication,
                       hop_latency_s=hop_latency_s, retry=retry)
