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
mesh axis name, a tuple of them, or ``None``.  ``sharding(*logical)``
and ``named(spec)`` turn a spec into a :class:`Sharding`, the mesh and
one DTensor placement per mesh dimension (the counterpart of
``NamedSharding``), and :func:`local_shard` cuts a rank's block of a
whole tensor by it.

Under the port's torch SPMD each rank holds its own shard and runs its
collectives over ``mesh.get_group(axis)`` (:func:`axes_group` for a
tuple of axes) through ``torch.distributed``: the device pushdown
(``core.pushdown_torch``), the sharded MoE bodies (``models.moe``) and
the int8 pod hop (``distributed.compression``).  The models see local
tensors, never global ones, so ``hint`` places nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import TYPE_CHECKING, Any, NamedTuple

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

    def sharding(self, *logical: Any) -> "Sharding":
        return self.named(self.spec(*logical))

    def named(self, spec: tuple) -> "Sharding":
        return Sharding(self.mesh, placements(self.mesh, spec))

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
    """``x`` itself: the port's models see each rank's local tensor,
    which a constraint on the global layout cannot move.  Under active
    rules the logical axes are resolved first, so an unknown name raises
    as it does in the reference."""
    rules = _ACTIVE.get()
    if rules is not None:
        rules.spec(*logical)
    return x


# --------------------------------------------------------------------------
# placements over a DeviceMesh
# --------------------------------------------------------------------------


class Sharding(NamedTuple):
    """A tensor's layout over a mesh: ``mesh`` and one DTensor placement
    per mesh dimension, so ``distribute_tensor(x, *sharding)`` and
    ``DTensor.from_local(local, *sharding)`` take it as it is."""
    mesh: "DeviceMesh"
    placements: tuple


def placements(mesh: "DeviceMesh", spec: tuple) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where the mesh axis
    appears in ``spec``'s entry for tensor dimension ``d``, ``Replicate()``
    elsewhere.

    A tuple entry shards its dimension over its axes major-first, as
    ``NamedSharding`` does; DTensor splits a dimension sharded on several
    mesh dimensions in mesh-dimension order, so the entry's axes must
    come in mesh order (the reference's tables list them so), and an
    axis may shard one dimension only.  Either fault raises
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {spec}: no mesh axis among {axes}; the "
                             f"mesh has {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {d} is sharded over "
                             f"{axes}, not in the mesh's order {names}; "
                             "DTensor would split it in another order")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dimensions")
            out[i] = Shard(d)
    return tuple(out)


def mesh_sizes(mesh: "DeviceMesh") -> dict[str, int]:
    """Each mesh axis's size; an object that only names its axes (no
    ``shape``) counts as one device on each."""
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, getattr(mesh, "shape", (1,) * len(names))))


def axes_size(mesh: "DeviceMesh", axes) -> int:
    """The product of the sizes of ``axes`` (a name, a tuple of names or
    ``None``: 1)."""
    if axes is None:
        return 1
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in
                     (axes if isinstance(axes, tuple) else (axes,)))


def local_shard(x: "torch.Tensor", sharding: Sharding) -> "torch.Tensor":
    """This rank's block of the whole tensor ``x`` under ``sharding``:
    what ``distribute_tensor(x, *sharding).to_local()`` holds, cut
    without a collective.  A dimension that its axes' sizes do not
    divide raises ``ValueError``, where ``NamedSharding`` refuses it
    (DTensor would pad)."""
    from torch.distributed.tensor import Shard

    mesh, place = sharding
    sizes = tuple(mesh_sizes(mesh).values())
    for d in range(x.ndim):
        n = math.prod(s for s, p in zip(sizes, place)
                      if isinstance(p, Shard) and p.dim == d)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of a {tuple(x.shape)} tensor "
                             f"does not divide into {n} shards")
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            step = x.shape[p.dim] // sizes[i]
            x = x.narrow(p.dim, coord[i] * step, step)
    return x.contiguous()


_GROUPS: dict = {}


def axes_group(mesh: "DeviceMesh", axes):
    """The process group over the product of ``axes`` (one name or a
    tuple in mesh order), its ranks in the axes' row-major order: one
    axis is ``mesh.get_group(axis)``; several get one group each over
    their product, made once per mesh by every rank together (as
    ``torch.distributed.new_group`` must be)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{names}")
        rest = [i for i in range(len(names)) if i not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axes_size(mesh, axes)).tolist()
        me = dist.get_rank()
        for ranks in rows:
            if ranks != sorted(ranks):
                raise ValueError(f"mesh ranks {ranks} along {axes} are not "
                                 "ascending: a group orders its ranks so")
            group = dist.new_group(ranks)
            if me in ranks:
                _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def spec_tree_to_shardings(rules: MeshRules, spec_tree):
    """A tree (dicts and lists) of mesh-axis spec tuples -> the same tree
    of :class:`Sharding`."""
    if isinstance(spec_tree, dict):
        return {k: spec_tree_to_shardings(rules, v)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [spec_tree_to_shardings(rules, v) for v in spec_tree]
    return rules.named(spec_tree)
