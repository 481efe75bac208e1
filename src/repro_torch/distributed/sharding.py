"""Logical-axis sharding rules: strategy tables per workload.

The counterpart of ``repro.distributed.sharding``.  Models are written
against *logical* axes; a :class:`MeshRules` over a ``torch.distributed``
``DeviceMesh`` resolves them to mesh axes under one of five strategies
(``STRATEGIES``; the reference's module docstring says what each is for).

Logical axes:
  dp           batch dimension of inputs/activations
  fsdp         dim-0 storage sharding of dense weights
  fsdp_expert  storage sharding of MoE expert weights (middle dim)
  tp           tensor-parallel dim (heads / d_ff / vocab / expert F)
  act_seq      sequence dim of the residual stream between layers
  sp           sequence dim of decode KV caches
  tokens       flattened token dim for shard-local MoE dispatch
  all          every mesh axis
and ``<axis>_nopod``, the same axis without "pod".

``spec(*logical)`` is a tuple with one entry per tensor dimension: a
mesh axis name, a tuple of them, or ``None``.  Under the port's torch
SPMD each rank holds its own shard; code that finds active rules
reduces its partials over ``mesh.get_group(axis)`` for each axis in
``dp_axes`` (``core.pushdown_torch``).  ``hint`` places nothing: the
serving path runs on one card, and tensor placement over a mesh waits
for the training slice.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    import torch
    from torch.distributed.device_mesh import DeviceMesh

_ACTIVE: contextvars.ContextVar["MeshRules | None"] = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None)

STRATEGIES = ("fsdp", "megatron_sp", "fsdp_dp", "tp_dp", "tp_sp")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: "DeviceMesh"
    strategy: str = "tp_sp"
    # axes already manual in an enclosing region: resolve() drops them
    manual_axes: tuple = ()

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")

    # ------------------------------------------------------------------
    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.all_axes)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names or ())

    @property
    def table(self) -> dict:
        dp, allax = self.dp_axes, self.all_axes
        model = "model" if "model" in allax else None
        if self.strategy == "fsdp":
            full = dp + ((model,) if model else ())
            return {"dp": full, "fsdp": full, "fsdp_expert": full,
                    "tp": None, "act_seq": None, "sp": model,
                    "tokens": full}
        if self.strategy == "megatron_sp":
            return {"dp": dp, "fsdp": dp, "fsdp_expert": dp,
                    "tp": model, "act_seq": model, "sp": model,
                    "tokens": dp + ((model,) if model else ())}
        if self.strategy == "fsdp_dp":
            full = dp + ((model,) if model else ())
            return {"dp": dp, "fsdp": full, "fsdp_expert": full,
                    "tp": None, "act_seq": None, "sp": model,
                    "tokens": dp}
        if self.strategy == "tp_dp":
            # Megatron-1D without sequence parallelism: batch over
            # (pod, data), heads/d_ff/state-heads TP over model, full-seq
            # activations.
            return {"dp": dp, "fsdp": dp, "fsdp_expert": dp,
                    "tp": model, "act_seq": None, "sp": model,
                    "tokens": dp}
        return {"dp": dp, "fsdp": dp, "fsdp_expert": dp,  # tp_sp
                "tp": model, "act_seq": None, "sp": model,
                "tokens": dp}

    # ------------------------------------------------------------------
    def resolve(self, logical: Any):
        """Translate one logical axis name to mesh axes (or None)."""
        out = self._resolve(logical)
        if not self.manual_axes or out is None:
            return out
        axes = out if isinstance(out, tuple) else (out,)
        kept = tuple(a for a in axes if a not in self.manual_axes)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    def _resolve(self, logical: Any):
        if logical is None:
            return None
        if logical in self.all_axes:  # explicit mesh axis: pass
            return logical
        if logical == "all":
            return self.all_axes
        if isinstance(logical, str) and logical.endswith("_nopod"):
            # variant of a logical axis excluding 'pod' (used when an
            # array carries an explicit leading pod dim, e.g. per-pod
            # error-feedback state)
            axes = self.resolve(logical[:-len("_nopod")])
            if axes is None:
                return None
            if not isinstance(axes, tuple):
                return None if axes == "pod" else axes
            rest = tuple(a for a in axes if a != "pod")
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        if logical in self.table:
            axes = self.table[logical]
            if isinstance(axes, tuple):
                if not axes:
                    return None
                return axes if len(axes) > 1 else axes[0]
            return axes
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical: Any) -> tuple:
        """The mesh axes of each tensor dimension."""
        return tuple(self.resolve(ax) for ax in logical)

    # ------------------------------------------------------------ moe
    @property
    def token_axes(self) -> tuple[str, ...]:
        t = self.table["tokens"]
        return t if isinstance(t, tuple) else (t,)

    @property
    def moe_tp(self) -> str | None:
        return self.table["tp"]


def active_rules() -> MeshRules | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def hint(x: "torch.Tensor", *logical: Any) -> "torch.Tensor":
    """``x`` itself.  Under active rules the logical axes are resolved
    first, so an unknown name raises as it does in the reference."""
    rules = _ACTIVE.get()
    if rules is not None:
        rules.spec(*logical)
    return x
