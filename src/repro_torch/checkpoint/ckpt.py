"""Checkpoints AS datasets: train state mapped to objects via core.

The train-state pytree is flattened to named leaves; each leaf's bytes
are partitioned into objects by ``core.partition`` (same grouping /
splitting / sizing machinery as any dataset — the checkpoint IS a mapped
dataset), placed and replicated by CRUSH, and committed atomically with
a manifest-last protocol:

  ckpt/<tag>/step-<n>/<leaf objects...>     (replicated data)
  ckpt/<tag>/step-<n>/.manifest             (commit record, written last)

A checkpoint without a readable manifest is invisible to ``restore`` —
a crash mid-save can never be restored from, and a
``PartialWriteError``'s ``persisted`` listing is sufficient to
reconcile (``reconcile_partial_save`` deletes the orphaned sub-writes
so the retry lands a bit-exact checkpoint).  OSD failures are tolerated
up to replicas-1 per object; ``ObjectStore.recover`` heals the rest.

``CheckpointManager`` adds async double-buffered saves (serialization +
store writes overlap the next train steps) and retention.

A sharded state (``train.steps.shard_train_state`` on a process group)
is saved once, whole, in the same layout: every rank takes part in
gathering each leaf, on its own thread, and one writer (rank 0) writes;
``latest_step(shared=True)`` lets the writer decide the step a restore
takes (``train.trainer`` drives both).

Leaves are tensors, on any device: they are keyed and serialized by
``repro_torch.pytree`` (the same key strings, dtype names and raw bytes
as every other checkpoint in the store, bf16 included), and ``restore``
puts each leaf on the device of the matching ``state_like`` leaf.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.core.logical import Column, LogicalDataset
from repro_torch.core.partition import PartitionPolicy, plan_partition
from repro_torch.core.store import (ObjectNotFound, ObjectStore,
                                    PartialWriteError)

_DEFAULT_POLICY = PartitionPolicy(target_object_bytes=8 << 20,
                                  max_object_bytes=32 << 20)


def _flatten(state) -> dict[str, torch.Tensor]:
    return {key: pytree.as_tensor(leaf)
            for key, leaf in pytree.flatten_with_keys(state)}


def _leaf_dataset(tag: str, step: int, idx: int,
                  arr: torch.Tensor) -> LogicalDataset:
    return LogicalDataset(
        f"ckpt/{tag}/step-{step}/leaf-{idx:05d}",
        (Column("bytes", "uint8"),),
        n_rows=arr.nbytes, unit_rows=max(arr.nbytes, 1))


def save(store: ObjectStore, state: Any, step: int, *, tag: str = "train",
         policy: PartitionPolicy = _DEFAULT_POLICY, workers: int = 8,
         extra: dict | None = None,
         window_bytes: int | None = None) -> dict:
    """Write a checkpoint; returns the manifest.

    The object mapping of every leaf is planned up front from shapes
    alone (cheap); the expensive part — serializing each leaf (a device
    leaf's copy to the host, then its bytes) — happens lazily.  When
    transfers take simulated time the whole checkpoint ships as ONE
    windowed streaming ``put_batch`` (one request per primary OSD for
    the entire checkpoint), so leaf i+1 serializes while leaf i's
    windows are still on the NIC — true cross-leaf encode/stream
    overlap.  The store's write ledger
    releases each sub-write's blob once it AND its replica chain land,
    so the client retains O(window) serialized bytes, never the whole
    checkpoint (``store.last_put_ledger_peak_bytes`` records the
    peak).  In-process stores (no simulated I/O) keep the buffered
    path: one batch per leaf, at most one leaf's blobs in memory.
    ``window_bytes`` overrides the store's default ingest window.
    ``workers`` is kept for API compatibility; parallelism is the
    store's, per OSD group.
    """
    del workers
    leaves = sorted(_flatten(state).items())
    manifest: dict = {"step": step, "tag": tag, "leaves": {},
                      "extra": extra or {}}
    planned = []  # (key, arr, omap) — no serialization yet
    for idx, (key, arr) in enumerate(leaves):
        ds = _leaf_dataset(tag, step, idx, arr)
        planned.append((key, arr, plan_partition(ds, policy)))

    def serialize(key, arr, omap) -> list[bytes]:
        raw = pytree.to_bytes(arr)
        manifest["leaves"][key] = {
            "dtype": pytree.DTYPE_NAMES[arr.dtype],
            "shape": list(arr.shape),
            "objects": [[e.name, e.row_start, e.row_stop]
                        for e in omap],
            "crc": zlib.crc32(raw)}
        return [raw[e.row_start:e.row_stop] for e in omap]

    window = store.default_window_bytes() if window_bytes is None \
        else window_bytes
    if window:
        names = [e.name for _, _, omap in planned for e in omap]
        store.put_batch(
            names,
            (blob for leaf in planned for blob in serialize(*leaf)),
            window_bytes=window)
    else:
        for key, arr, omap in planned:
            store.put_batch([e.name for e in omap],
                            serialize(key, arr, omap))

    # commit record LAST — atomicity point (and only after every leaf's
    # meta was filled in by its serialize())
    store.put(f"ckpt/{tag}/step-{step}/.manifest",
              json.dumps(manifest).encode())
    return manifest


def reconcile_partial_save(store: ObjectStore,
                           err: PartialWriteError) -> list[str]:
    """Crash-consistency reconcile for a ``save`` that died mid-stream
    (e.g. its producer was killed, or the entry OSD went down past the
    failover budget): the raised :class:`PartialWriteError` lists
    exactly which sub-writes persisted (``(name, version)`` pairs), and
    since the manifest is written LAST the torn checkpoint is already
    invisible to ``restore`` — so reconciliation is just deleting those
    orphaned data objects and retrying the save from scratch.  Returns
    the names deleted.  Idempotent: already-gone objects are skipped."""
    deleted = []
    for name, _version in err.persisted:
        try:
            store.delete(name)
        except (ObjectNotFound, KeyError):
            continue
        deleted.append(name)
    return deleted


def is_writer() -> bool:
    """Whether this process writes a sharded state's checkpoint: rank 0
    of the default process group (the mesh's rank 0), or the only
    process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def latest_step(store: ObjectStore, *, tag: str = "train",
                shared: bool = False) -> int | None:
    """The newest committed step of ``tag``, or None.  ``shared``: every
    rank of the default process group calls it together, the writer
    (:func:`is_writer`) reads its store and broadcasts its answer (each
    rank's in-process store is its own replica; the writer's decides)."""
    if shared:
        import torch.distributed as dist
        box = [latest_step(store, tag=tag) if is_writer() else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    steps = []
    for name in store.list_objects(f"ckpt/{tag}/step-"):
        if name.endswith("/.manifest"):
            try:
                steps.append(int(name.split("step-")[1].split("/")[0]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(store: ObjectStore, state_like: Any, *, step: int | None = None,
            tag: str = "train", workers: int = 8) -> tuple[Any, dict]:
    """Rebuild the tree (structured like ``state_like``) from objects.
    Each leaf comes back as a tensor of the stored dtype, on the device
    of its ``state_like`` leaf (the host for arrays and scalars)."""
    if step is None:
        step = latest_step(store, tag=tag)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for tag {tag!r}")
    manifest = json.loads(
        store.get(f"ckpt/{tag}/step-{step}/.manifest").decode())

    def get_leaf(meta: dict) -> tuple[bytearray, dict]:
        raw = bytearray()
        for n, _, _ in meta["objects"]:
            raw += store.get(n)
        if zlib.crc32(raw) != meta["crc"]:
            raise IOError("checkpoint leaf corrupt")
        return raw, meta

    keys = sorted(manifest["leaves"])
    with ThreadPoolExecutor(max_workers=workers) as pool:
        arrays = list(pool.map(
            lambda k: get_leaf(manifest["leaves"][k]), keys))
    by_key = dict(zip(keys, arrays))

    def leaf_of(key: str, leaf: Any) -> torch.Tensor:
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        raw, meta = by_key[key]
        want = tuple(getattr(leaf, "shape", ()) or ())
        if tuple(meta["shape"]) != want:
            raise ValueError(f"{key}: shape {tuple(meta['shape'])} != "
                             f"{want}")
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return pytree.from_bytes(raw, meta["dtype"], meta["shape"], device)

    state = pytree.map_with_keys(leaf_of, state_like)
    return state, manifest


class CheckpointManager:
    """Async saves + retention.  ``maybe_save`` snapshots to host (a
    synchronous copy of every leaf, complete before it returns, so a
    train step may mutate the tensors at once) then writes to the store
    on a background thread so training overlaps the object writes.
    ``shared``: a sharded state's saves, taken once (``maybe_save``).
    ``timings`` records each save: its step, bytes, the snapshot's wall
    and the background write's."""

    def __init__(self, store: ObjectStore, *, tag: str = "train",
                 every_steps: int = 100, keep: int = 3,
                 policy: PartitionPolicy = _DEFAULT_POLICY,
                 shared: bool = False):
        self.store = store
        self.tag = tag
        self.every_steps = every_steps
        self.keep = keep
        self.policy = policy
        self.shared = shared
        self._pending: threading.Thread | None = None
        self.saved_steps: list[int] = []
        self.timings: list[dict] = []

    def maybe_save(self, state: Any, step: int,
                   extra: dict | None = None) -> bool:
        """Save at ``step`` if it is due.  ``state`` is the tree, or a
        callable ``snapshot(writer)`` returning it as fresh host tensors,
        called only when due.  A ``shared`` manager's ``maybe_save`` is
        called by every rank of the default process group together:
        ``snapshot`` runs on each on the caller's thread, in the same
        order (its collectives), returning the tree on the writer
        (:func:`is_writer`) and None elsewhere; only the writer
        serializes and writes, and only its store receives the
        checkpoint.  Otherwise this process is the writer."""
        if step % self.every_steps:
            return False
        writer = not self.shared or is_writer()
        if writer:
            self.wait()
        t = time.perf_counter()
        if callable(state):
            host_state = state(writer)
        else:                                     # device->host snap
            host_state = pytree.map_with_keys(
                lambda _key, leaf: pytree.host_copy(leaf), state)
        if not writer:
            return True
        rec = {"step": step, "snapshot_s": time.perf_counter() - t,
               "bytes": sum(leaf.nbytes for _, leaf in
                            pytree.flatten_with_keys(host_state))}

        def work():
            t = time.perf_counter()
            save(self.store, host_state, step, tag=self.tag,
                 policy=self.policy, extra=extra)
            rec["write_s"] = time.perf_counter() - t
            self.timings.append(rec)
            self.saved_steps.append(step)
            self._retire()

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _retire(self) -> None:
        while len(self.saved_steps) > self.keep:
            old = self.saved_steps.pop(0)
            prefix = f"ckpt/{self.tag}/step-{old}/"
            # delete manifest FIRST so a partially-deleted ckpt is invisible
            try:
                self.store.delete(prefix + ".manifest")
            except ObjectNotFound:
                pass
            for name in self.store.list_objects(prefix):
                self.store.delete(name)
