"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

The counterpart of ``repro.train.optimizer``.  Moments are kept in
``opt_dtype`` (float32 by default) beside their parameters; params may
be bf16: the update is computed in float32, term for term as the
reference writes it, and cast back.  The update is applied in place
under ``torch.no_grad()``, the counterpart of the reference's donated
state, and keeps the step's scalars (learning rate, clip scale, bias
corrections) on the parameters' device, so it needs no host sync.
``torch.optim.AdamW`` is not used: its update rounds differently and it
has no global clip.

Trees are dicts, lists or tuples of tensors (``repro_torch.pytree``);
``grads``, ``params``, ``m`` and ``v`` share one structure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import pytree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (0-d integer tensor) -> learning rate (0-d float32 on the
    step's device): linear warmup, then cosine decay to
    ``min_lr_frac``."""
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi, step) * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return f


def _leaves(tree) -> list:
    return [leaf for _, leaf in pytree.flatten_with_keys(tree)]


def _map(fn, tree):
    return pytree.map_with_keys(lambda _key, leaf: fn(leaf), tree)


def init_opt_state(params, opt_dtype=torch.float32) -> dict:
    """Zero moments beside each parameter, and step 0 (0-d int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=opt_dtype, device=p.device)

    step_dev = _leaves(params)[0].device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def abstract_opt_state(param_shapes, opt_dtype=torch.float32) -> dict:
    """``init_opt_state``'s tree as meta tensors: no allocation."""
    def meta(p):
        return torch.empty(p.shape, dtype=opt_dtype, device="meta")

    return {"m": _map(meta, param_shapes), "v": _map(meta, param_shapes),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_specs(param_specs) -> dict:
    """The moments are placed as their parameters; the step replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree, groups=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.  Where
    ``groups`` (one per leaf) names a process group, the leaf is this
    rank's block of a sharded whole: the blocks' sums are added over the
    group; a leaf with None counts once."""
    sq = [x.float().square().sum() for x in _leaves(tree)]
    if groups is None:
        return torch.stack(sq).sum().sqrt()
    from repro_torch.distributed import sharding as shd

    total, by_group = [], {}
    for s, group in zip(sq, groups):
        (total if group is None else by_group.setdefault(group, [])
         ).append(s)
    for group, parts in by_group.items():
        total.append(shd.all_reduce_(torch.stack(parts).sum(), group))
    return torch.stack(total).sum().sqrt()


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, params, opt_state, decay=None):
    """One AdamW step, in place on ``params`` and ``opt_state`` (its
    ``m``, ``v`` and ``step``).  Returns ``(params, opt_state,
    grad_norm)``, the first two being the objects passed in.

    Weight decay applies where ``p.ndim >= 2`` (norms and biases are
    1-D), or where ``decay``, a tree of bools shaped like ``params``,
    says so.  Under active rules, sharded parameters' gradients are
    their blocks, and the clip's norm adds the blocks' squares over
    their groups (``global_norm``)."""
    from repro_torch.distributed import sharding as shd

    g_leaves = _leaves(grads)
    p_leaves = _leaves(params)
    rules = shd.active_rules()
    groups = (None if rules is None else
              [shd.norm_group(p, rules) for p in p_leaves])
    decays = ([p.ndim >= 2 for p in p_leaves] if decay is None
              else _leaves(decay))
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    lr = lr_schedule(cfg)(step)
    b1, b2 = cfg.betas

    gnorm = global_norm(grads, groups)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    bc1 = 1 - _f32(b1, step) ** stepf
    bc2 = 1 - _f32(b2, step) ** stepf

    for g, p, m, v, dec in zip(g_leaves, p_leaves, _leaves(opt_state["m"]),
                               _leaves(opt_state["v"]), decays):
        g = g.float() * scale
        m1 = b1 * m.float() + (1 - b1) * g
        v1 = b2 * v.float() + (1 - b2) * g.square()
        del g
        m.copy_(m1)
        v.copy_(v1)
        upd = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps)
        del m1, v1
        pf = p.float()
        wd = cfg.weight_decay if dec else 0.0
        p.copy_(pf - lr * (upd + wd * pf))
    opt_state["step"].copy_(step)
    return params, opt_state, gnorm
