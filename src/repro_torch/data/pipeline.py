"""ObjectDataLoader — VOL-planned batch fetch with prefetch overlap.

The loader is the GlobalVOL acting as a training-data client:

  * deterministic: (seed, epoch) -> permutation of sequence rows; a step
    is a pure function of the loader state, so restart-from-checkpoint
    replays the exact same data order (fault tolerance requirement);
  * data-parallel aligned: each host/dp-rank fetches only its slice of
    the global batch (``dp_rank``/``dp_size``), and the per-object
    sub-requests run storage-side (select pushdown) so only that slice
    moves — compiled and executed through the shared ``ScanEngine``
    (``fetch_objects``), so a plain fetch rides the server-concat plane
    (ONE framed table response per OSD) and a packed fetch gathers raw
    word partials, never one request per contiguous run;
  * packed mode: rows are fetched as planar-bitpacked words via the
    zero-decode ``select_packed`` objclass op — bytes on the wire (and
    onto the card) are ~bits/32 of raw, and the unpack runs on the card
    in front of the step (``data.fused_ingest``);
  * prefetch: a background thread keeps ``prefetch`` batches ahead, so
    storage latency overlaps step compute;
  * windowed streaming (``window_steps > 1``): the producer fetches
    several steps' runs in ONE streaming gather and assembles each
    step's batch the moment ITS frames land (``ScanEngine.
    fetch_objects_stream`` delivers per-OSD frames in arrival order),
    so early batches reach the trainer while the slowest OSD is still
    serving later steps' rows — batches stay bit-identical and in step
    order;
  * straggler mitigation: reads hedge to a replica after
    ``hedge_timeout_s`` (paper: "fully leveraging ... load balancing ...
    of distributed storage systems").
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch import obs
from repro_torch.core import objclass as oc
from repro_torch.core.logical import RowRange
from repro_torch.core.partition import ObjectMap
from repro_torch.core.vol import GlobalVOL


@dataclasses.dataclass
class LoaderState:
    """Serializable resume point (stored inside checkpoints)."""

    step: int = 0

    def to_json(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def from_json(d: dict) -> "LoaderState":
        return LoaderState(step=int(d["step"]))


class ObjectDataLoader:
    def __init__(
        self,
        vol: GlobalVOL,
        dataset_name: str,
        *,
        global_batch: int,
        dp_rank: int = 0,
        dp_size: int = 1,
        seed: int = 0,
        packed: bool = False,
        prefetch: int = 2,
        window_steps: int = 1,
        hedge_timeout_s: float | None = None,
        start_step: int = 0,
    ):
        if global_batch % dp_size:
            raise ValueError(f"global_batch {global_batch} % dp_size "
                             f"{dp_size} != 0")
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, "
                             f"got {window_steps}")
        if window_steps > 1 and prefetch < 1:
            raise ValueError("window_steps > 1 needs the prefetch "
                             "producer (prefetch >= 1) — the windowed "
                             "streaming fetch runs there")
        if window_steps > 1 and hedge_timeout_s is not None:
            raise ValueError("window_steps > 1 cannot combine with "
                             "hedge_timeout_s (hedged reads bypass the "
                             "engine's streaming gather)")
        self.vol = vol
        self.omap: ObjectMap = vol.open(dataset_name)
        self.ds = self.omap.dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // dp_size
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.seed = seed
        self.packed = packed
        self.window_steps = window_steps
        self.hedge_timeout_s = hedge_timeout_s
        self.state = LoaderState(step=start_step)
        self.steps_per_epoch = max(self.ds.n_rows // global_batch, 1)
        # streaming-consume observability: set per window by the
        # windowed producer — how many of the window's per-object
        # results had landed when its FIRST batch was assembled (the
        # "first batch out before the slowest OSD finished" claim)
        self.last_window_stats: dict | None = None

        self._prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if prefetch > 0:
            self._thread = threading.Thread(
                target=self._producer, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ ordering
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(self.ds.n_rows)

    def rows_for_step(self, step: int) -> np.ndarray:
        """Global row ids of this dp-rank's slice of the step's batch."""
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        perm = self._epoch_perm(epoch)
        batch = perm[within * self.global_batch:
                     (within + 1) * self.global_batch]
        if batch.size < self.global_batch:  # tail: wrap deterministically
            batch = np.concatenate(
                [batch, perm[:self.global_batch - batch.size]])
        return np.sort(batch[self.dp_rank::self.dp_size])

    # ------------------------------------------------------------ fetch
    def _runs_for(self, rows: np.ndarray) -> list[tuple]:
        """Group sorted rows into per-object contiguous runs:
        (extent, run, lo, hi) tuples."""
        runs: list[tuple] = []
        i = 0
        while i < len(rows):
            subs = self.omap.lookup(RowRange(int(rows[i]),
                                             int(rows[i]) + 1))
            extent, _ = subs[0]
            j = i
            while j < len(rows) and rows[j] < extent.row_stop:
                j += 1
            run = rows[i:j]
            lo = int(run[0] - extent.row_start)
            hi = int(run[-1] - extent.row_start) + 1
            runs.append((extent, run, lo, hi))
            i = j
        return runs

    def _run_pipelines(self, runs: list[tuple]) -> list[list]:
        if self.packed:
            return [[oc.op("select_packed", rows=(lo, hi), col="tokens")]
                    for _, _, lo, hi in runs]
        # row_slice carries GLOBAL dataset rows; each OSD resolves its
        # object's sub-range from its own extent xattr at execute time
        # (same pushed-down row-range plane as Scan.rows)
        return [[oc.op("row_slice", rows=(e.row_start + lo,
                                          e.row_start + hi)),
                 oc.op("project", cols=["tokens"])]
                for e, _, lo, hi in runs]

    def _assemble(self, runs: list[tuple],
                  results: list) -> dict[str, np.ndarray]:
        """Per-run results (aligned with ``runs``) -> one batch."""
        if self.packed:
            packed_parts = []
            for (extent, run, lo, _), res in zip(runs, results):
                words = res["packed"]          # (hi-lo, S/32, bits)
                keep = (run - extent.row_start - lo).astype(np.int64)
                packed_parts.append(words[keep])
            return {"tokens_packed": np.concatenate(packed_parts, axis=0)}

        parts = []
        for (extent, run, lo, _), tab in zip(runs, results):
            keep = (run - extent.row_start - lo).astype(np.int64)
            parts.append(tab["tokens"][keep])
        toks = np.concatenate(parts, axis=0)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1  # no target across sequence boundary
        return {"tokens": toks, "labels": labels}

    def _fetch_rows(self, rows: np.ndarray) -> dict[str, np.ndarray]:
        """Group sorted rows into per-object contiguous runs, then fetch
        ALL runs with one batched objclass request per OSD (packed or
        decoded) — the train input path pays fabric ops per OSD, not per
        run."""
        runs = self._runs_for(rows)
        results = self._exec_runs(runs, self._run_pipelines(runs))
        return self._assemble(runs, results)

    def _fetch_window(self, start_step: int):
        """Windowed streaming fetch: ONE gather for ``window_steps``
        steps' runs, yielding ``(step, batch)`` in step order as each
        step's frames land — the engine streams per-OSD result frames
        in arrival order, so step s's batch goes out the moment ITS
        runs are complete, even while the slowest OSD is still serving
        later steps' rows."""
        steps = list(range(start_step, start_step + self.window_steps))
        runs_per_step = [self._runs_for(self.rows_for_step(s))
                         for s in steps]
        flat_runs = [r for runs in runs_per_step for r in runs]
        owner = [k for k, runs in enumerate(runs_per_step)
                 for _ in runs]
        results: list = [None] * len(flat_runs)
        missing = [len(runs) for runs in runs_per_step]
        emitted = 0
        landed = 0
        for i, res in self.vol.engine.fetch_objects_stream(
                [e.name for e, _, _, _ in flat_runs],
                self._run_pipelines(flat_runs), packed=self.packed):
            results[i] = res
            landed += 1
            missing[owner[i]] -= 1
            # flush every leading step whose runs are all present (step
            # order is the loader's determinism contract)
            while emitted < len(steps) and missing[emitted] == 0:
                if emitted == 0:
                    self.last_window_stats = {
                        "results_at_first_yield": landed,
                        "total_results": len(flat_runs),
                        "window_steps": self.window_steps,
                    }
                lo = sum(len(r) for r in runs_per_step[:emitted])
                runs = runs_per_step[emitted]
                yield steps[emitted], self._assemble(
                    runs, results[lo:lo + len(runs)])
                emitted += 1

    def _exec_runs(self, runs: list[tuple], pipelines: list[list]):
        """Per-run results (decoded tables, or packed word partials),
        aligned with ``runs``."""
        names = [e.name for e, _, _, _ in runs]
        if self.hedge_timeout_s is not None:
            # hedged read of the raw objects, then local pipelines: used
            # when an OSD is straggling (exec would block on the slow
            # primary).  The loader resolves row_slice itself — it
            # knows each run's extent from the omap it planned with.
            return [oc.run_pipeline(
                self.vol.store.get_hedged(e.name, self.hedge_timeout_s),
                oc.resolve_row_slice(p, (e.row_start, e.row_stop),
                                     clamp=True),
                encode=False)
                for (e, _, _, _), p in zip(runs, pipelines)]
        return self.vol.engine.fetch_objects(names, pipelines,
                                             packed=self.packed)

    # ------------------------------------------------------------ iterate
    def make_batch(self, step: int) -> dict[str, np.ndarray]:
        """Step ``step``'s batch: the span ``loader.fetch``, on the
        producer's thread where there is one."""
        with obs.span("loader.fetch", step=step):
            return self._fetch_rows(self.rows_for_step(step))

    def _producer(self) -> None:
        step = self.state.step
        # hedged reads bypass the engine (per-object raw gets), so the
        # windowed streaming consume only applies without them
        windowed = self.window_steps > 1 and self.hedge_timeout_s is None
        while not self._stop.is_set():
            try:
                if windowed:
                    for _, batch in self._fetch_window(step):
                        self._q.put(batch)
                        step += 1
                        if self._stop.is_set():
                            return
                else:
                    self._q.put(self.make_batch(step))
                    step += 1
            except Exception as e:  # surface in consumer
                self._q.put(e)
                return

    def __next__(self) -> dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.make_batch(self.state.step)
        else:
            with obs.span("loader.wait"):
                batch = self._q.get()
            if isinstance(batch, Exception):
                raise batch
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def seek(self, step: int) -> None:
        """Reposition the loader so the NEXT consumed batch is
        ``step``'s.  A batch is a pure function of (seed, step), so a
        seek is exact: the prefetch producer is restarted at the new
        position and re-fills its window from there — how the trainer
        resumes from a checkpoint without losing prefetch/windowed
        overlap.  A seek to the current position is free (the already-
        prefetched batches stay valid)."""
        if step == self.state.step:
            return  # queue holds [state.step, ...) — already positioned
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():  # unblock a parked producer
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    self._thread.join(timeout=0.005)
            self._thread = None
        self.state.step = step
        if self._prefetch > 0:
            self._q = queue.Queue(maxsize=max(self._prefetch, 1))
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._producer, daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            while True:  # drain so the producer can exit
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
