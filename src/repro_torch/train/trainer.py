"""Training loop: object-store data path, checkpoint/restart, straggler
detection — the counterpart of ``repro.train.trainer``.

Everything stateful lives in the object store (checkpoints AND the data
order, which is a pure function of (seed, step)), so a restart from any
committed step is bit-deterministic: same params, same optimizer
moments, same next batch.  Checkpoints hold the state in the
reference's layout (``train_state_to_reference``), so each package
restores the other's.  The state lives on the model's device; the loop
takes one host sync per step, to read the step's metrics.

Over sharded state: ``Trainer(..., rules=MeshRules(...))``, on every
rank of a process group whose ranks are the mesh's, shards a fresh or
restored state (``steps.shard_train_state``) and runs each step under
the rules on the rank's block of the batch: a loader of the whole batch
is cut on the host (``models.inputs.shard_batch``), a loader that
already reads the rank's rows
(``dp_rank`` / ``dp_size`` the rank's index in and size of the "dp"
group) is taken as it is; with packed ingest each rank unpacks its own
words on its device.  Checkpoints hold the whole state once
(``checkpoint.ckpt.CheckpointManager(shared=True)``: every rank
gathers each leaf, rank 0 writes) and a restore gives each rank its
blocks (``transformer.sharded_state_from_reference``).  ``history``
holds the same metrics on every rank.  The rules are given, not read
from the context: the Trainer makes the state they cut.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointManager, is_writer,
                                        latest_step, restore)
from repro_torch.core.store import ObjectStore
from repro_torch.data.fused_ingest import make_fused_train_step
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.distributed import sharding as shd
from repro_torch.models.inputs import shard_batch
from repro_torch.models.transformer import (sharded_state_from_reference,
                                            sharded_state_to_reference,
                                            train_state_from_reference)
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.steps import (abstract_train_state, init_train_state,
                                     make_train_step, shard_params,
                                     shard_train_state)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``factor`` x EWMA.

    On a real pod the flag triggers hedged reads / slot replacement; here
    it feeds the loader's hedging and the trainer's log.
    """

    alpha: float = 0.1
    factor: float = 2.0
    ewma_s: float | None = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma_s is None:
            self.ewma_s = dt
            return False
        slow = dt > self.factor * self.ewma_s
        self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * dt
        self.flagged += int(slow)
        return slow


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_keep: int = 2
    ckpt_tag: str = "train"
    log_every: int = 10
    packed_ingest: bool = False


def _host_tensors(batch: dict) -> dict:
    """A loader batch's arrays as host tensors; uint32 words are carried
    as int32 tensors of the same bits."""
    out = {}
    for k, v in batch.items():
        a = np.ascontiguousarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a)
    return out


def _on_device(batch: dict, device: torch.device) -> dict:
    """A loader batch's arrays as tensors on ``device`` (uint32 words as
    int32 tensors of the same bits)."""
    return {k: t.to(device) for k, t in _host_tensors(batch).items()}


class Trainer:
    def __init__(self, model, loader: ObjectDataLoader,
                 store: ObjectStore, *,
                 opt: OptConfig = OptConfig(),
                 cfg: TrainerConfig = TrainerConfig(),
                 step_fn: Callable | None = None,
                 log: Callable[[str], None] = print,
                 rules: shd.MeshRules | None = None):
        """``rules``: shard the state and run each step under them (the
        module docstring)."""
        self.model = model
        self.loader = loader
        self.store = store
        self.cfg = cfg
        self.opt = opt
        self.log = log
        self.rules = rules
        if rules is not None:
            self._check_loader()
        base = step_fn or make_train_step(model, opt)
        if cfg.packed_ingest:
            fused = make_fused_train_step(base)
            base = lambda s, b: fused(s, b["tokens_packed"])  # noqa: E731
        self.train_step = base
        self.ckpts = CheckpointManager(
            store, tag=cfg.ckpt_tag, every_steps=cfg.ckpt_every,
            keep=cfg.ckpt_keep, shared=rules is not None)
        self.straggler = StragglerMonitor()
        self.history: list[dict] = []

    def _check_loader(self) -> None:
        """A loader of the rank's rows must be the rank's "dp" block."""
        size = getattr(self.loader, "dp_size", 1)
        if size == 1:
            return
        dp = shd.logical_group(self.rules, "dp")
        want = (dp.size, dp.index) if dp is not None else (1, 0)
        if (size, self.loader.dp_rank) != want:
            raise ValueError(f"a loader of rows {self.loader.dp_rank} of "
                             f"{size} where the rules' dp block is "
                             f"{want[1]} of {want[0]}")

    def _batch(self, batch: dict) -> dict:
        """The step's batch on the model's device: the rank's block of a
        whole batch under rules."""
        host = _host_tensors(batch)
        if self.rules is not None and getattr(self.loader, "dp_size",
                                              1) == 1:
            host = shard_batch(host, self.rules)
        device = self.model.device
        return {k: t.to(device) for k, t in host.items()}

    # ------------------------------------------------------------ state
    def init_or_restore(self, seed: int = 0) -> tuple[Any, int]:
        """Fresh state (weights drawn from a ``torch.Generator`` seeded
        with ``seed`` on the model's device), or the latest committed
        checkpoint if one exists; cut to the rank's blocks under
        ``rules`` (every rank calls it together: the writer decides the
        step and holds the whole checkpoint, each rank gets its
        blocks)."""
        if self.rules is not None:
            return self._init_or_restore_sharded(seed)
        opt_dtype = self.model.cfg.opt_dtype
        step = latest_step(self.store, tag=self.cfg.ckpt_tag)
        if step is None:
            gen = torch.Generator(device=self.model.device).manual_seed(seed)
            return init_train_state(self.model, gen, opt_dtype), 0
        restored, manifest = self._restore(step)
        return train_state_from_reference(self.model, restored), step

    def _restore(self, step: int):
        shapes, _ = abstract_train_state(self.model, self.model.cfg.opt_dtype)
        restored, manifest = restore(self.store, _host_like(shapes),
                                     step=step, tag=self.cfg.ckpt_tag)
        self.log(f"[trainer] restored step {step} "
                 f"(loader resumes at {manifest['extra'].get('loader_step')})")
        return restored, manifest

    def _init_or_restore_sharded(self, seed: int) -> tuple[Any, int]:
        """A fresh model's state cut under ``rules``: drawn from ``seed``
        and cut, or restored into its cut parameters and zero moments of
        their blocks' shapes (the writer reads the checkpoint and
        scatters each rank's blocks)."""
        model, opt_dtype = self.model, self.model.cfg.opt_dtype
        if any(shd.is_sharded(p) for p in model.parameters()):
            raise ValueError("the model's parameters are already cut: a "
                             "sharded Trainer needs a fresh model")
        step = latest_step(self.store, tag=self.cfg.ckpt_tag, shared=True)
        if step is None:
            gen = torch.Generator(device=model.device).manual_seed(seed)
            return shard_train_state(model, init_train_state(
                model, gen, opt_dtype), self.rules), 0
        shard_params(model, self.rules)
        params = dict(model.named_parameters())
        state = {"params": params, "opt": init_opt_state(params, opt_dtype)}
        tree = self._restore(step)[0] if is_writer() else None
        return sharded_state_from_reference(model, state, tree,
                                            self.rules), step

    def _save(self, state, step: int) -> None:
        """The reference's layout of ``state`` (whole leaves on the host,
        gathered by every rank when sharded), built only when due."""
        rules = self.rules
        self.ckpts.maybe_save(
            lambda writer: sharded_state_to_reference(state, rules, writer),
            step, extra={"loader_step": step})

    # ------------------------------------------------------------ loop
    def run(self, state=None, *, start_step: int | None = None,
            on_step: Callable[[int], None] | None = None) -> Any:
        if state is None:
            state, start = self.init_or_restore()
            start_step = start if start_step is None else start_step
        start_step = start_step or 0
        # exact reposition (data order is a pure function of step); the
        # consume below rides the loader's prefetch queue, so storage
        # fetches overlap step compute instead of serializing ahead of it
        self.loader.seek(start_step)

        for step in range(start_step, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = self._batch(next(self.loader))
            with (shd.use_rules(self.rules) if self.rules is not None
                  else contextlib.nullcontext()):
                state, metrics = self.train_step(state, batch)
            names = list(metrics)
            values = torch.stack([metrics[k].float().reshape(())
                                  for k in names]).tolist()   # one sync
            metrics = dict(zip(names, values))
            dt = time.perf_counter() - t0
            slow = self.straggler.observe(dt)
            rec = dict(metrics, step=step + 1, wall_s=dt, straggler=slow)
            self.history.append(rec)
            if (step + 1) % self.cfg.log_every == 0 or slow:
                self.log(f"[trainer] step {step + 1} "
                         f"loss={metrics['loss']:.4f} "
                         f"{dt * 1000:.0f}ms" + (" STRAGGLER" if slow else ""))
            if (step + 1) % self.ckpts.every_steps == 0:
                t = time.perf_counter()
                self._save(state, step + 1)
                rec["ckpt_s"] = time.perf_counter() - t
            if on_step is not None:
                on_step(step + 1)
        self.ckpts.wait()
        return state


def _host_like(tree):
    """Meta leaves -> empty host tensors of the same shape and dtype
    (what ``restore`` reads shapes and the target device from)."""
    if isinstance(tree, dict):
        return {k: _host_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_like(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype)
