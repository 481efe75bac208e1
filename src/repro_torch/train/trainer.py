"""Training loop: object-store data path, checkpoint/restart, straggler
detection — the counterpart of ``repro.train.trainer``.

Everything stateful lives in the object store (checkpoints AND the data
order, which is a pure function of (seed, step)), so a restart from any
committed step is bit-deterministic: same params, same optimizer
moments, same next batch.  Checkpoints hold the state in the
reference's layout (``train_state_to_reference``), so each package
restores the other's.  The state lives on the model's device; the loop
takes one host sync per step, to read the step's metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step, restore
from repro_torch.core.store import ObjectStore
from repro_torch.data.fused_ingest import make_fused_train_step
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models.transformer import (train_state_from_reference,
                                            train_state_to_reference)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (abstract_train_state, init_train_state,
                                     make_train_step)


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


def _on_device(batch: dict, device: torch.device) -> dict:
    """A loader batch's arrays as tensors on ``device``; uint32 words
    are carried as int32 tensors of the same bits."""
    out = {}
    for k, v in batch.items():
        a = np.ascontiguousarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a).to(device)
    return out


class Trainer:
    def __init__(self, model, loader: ObjectDataLoader,
                 store: ObjectStore, *,
                 opt: OptConfig = OptConfig(),
                 cfg: TrainerConfig = TrainerConfig(),
                 step_fn: Callable | None = None,
                 log: Callable[[str], None] = print):
        self.model = model
        self.loader = loader
        self.store = store
        self.cfg = cfg
        self.opt = opt
        self.log = log
        base = step_fn or make_train_step(model, opt)
        if cfg.packed_ingest:
            fused = make_fused_train_step(base)
            base = lambda s, b: fused(s, b["tokens_packed"])  # noqa: E731
        self.train_step = base
        self.ckpts = CheckpointManager(
            store, tag=cfg.ckpt_tag, every_steps=cfg.ckpt_every,
            keep=cfg.ckpt_keep)
        self.straggler = StragglerMonitor()
        self.history: list[dict] = []

    # ------------------------------------------------------------ state
    def init_or_restore(self, seed: int = 0) -> tuple[Any, int]:
        """Fresh state (weights drawn from a ``torch.Generator`` seeded
        with ``seed`` on the model's device), or the latest committed
        checkpoint if one exists."""
        opt_dtype = self.model.cfg.opt_dtype
        step = latest_step(self.store, tag=self.cfg.ckpt_tag)
        if step is None:
            gen = torch.Generator(device=self.model.device).manual_seed(seed)
            return init_train_state(self.model, gen, opt_dtype), 0
        shapes, _ = abstract_train_state(self.model, opt_dtype)
        restored, manifest = restore(self.store, _host_like(shapes),
                                     step=step, tag=self.cfg.ckpt_tag)
        self.log(f"[trainer] restored step {step} "
                 f"(loader resumes at {manifest['extra'].get('loader_step')})")
        return train_state_from_reference(self.model, restored), step

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
        device = self.model.device

        for step in range(start_step, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = _on_device(next(self.loader), device)
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
                # the reference's layout, built on the host only when due
                t = time.perf_counter()
                self.ckpts.maybe_save(train_state_to_reference(state),
                                      step + 1,
                                      extra={"loader_step": step + 1})
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
