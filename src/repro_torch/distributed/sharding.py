"""Mesh rules: which mesh dimensions are the data-parallel axes.

The counterpart of ``repro.distributed.sharding``, cut to what the
device pushdown (``core.pushdown_torch``) reads: a :class:`MeshRules`
over a ``torch.distributed`` ``DeviceMesh``, its data-parallel axes
(``dp_axes``: the mesh dimensions named "pod" and "data" that exist)
and every axis (``all_axes``), and the active rules of the current
context (``active_rules``/``use_rules``).

Under the port's torch SPMD each rank holds its own shard; code that
finds active rules reduces its partials over ``mesh.get_group(axis)``
for each axis in ``dp_axes``.  The logical-axis table (``resolve``,
``spec``, ``hint``) waits for the models.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

_ACTIVE: contextvars.ContextVar["MeshRules | None"] = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None)

STRATEGIES = ("fsdp", "megatron_sp", "fsdp_dp", "tp_dp", "tp_sp")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: "DeviceMesh"
    strategy: str = "tp_sp"
    # axes already manual in an enclosing region (kept for the
    # reference's signature; nothing in the port reads it yet)
    manual_axes: tuple = ()

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names or ())

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.all_axes)


def active_rules() -> MeshRules | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)
