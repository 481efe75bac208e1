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

FSDP execution (ZeRO-3).  :func:`fit_spec` and :func:`resolve_tree` are
the reference's ``_fit_spec`` and ``resolve_tree`` (``launch/dryrun.py``):
a dimension keeps the leading axes of its spec entry that divide it.
``train.steps.shard_train_state`` cuts each parameter and moment to this
rank's block of that fitted spec and marks the parameter with its
logical spec and whole shape (``mark_sharded``).  Inside the models,
:func:`gathered` swaps a module's marked parameters for their gathered
tensors for the length of a block, each through :class:`GatherParam`:
forward, a tiled all-gather of the block on its storage dimension
(``fsdp`` / ``fsdp_expert``) over ``axes_group(mesh, axes)``; backward,
the gradient reduce-scattered back to the block and all-reduced over the
active axes that neither store nor split it.

The model axis (tensor parallelism).  A ``tp`` dimension is not
gathered: the layer runs on the rank's slice (heads, d_ff, experts' F,
the vocabulary) and writes its collectives itself, Megatron-style, as
the reference's GSPMD inserts them: :func:`all_gather`,
:func:`reduce_scatter` and :func:`all_reduce` are autograd functions
whose backward is their exact adjoint (gather <-> reduce-scatter on the
same dimension, sum <-> sum); :func:`logical_group` names the group of
a logical axis (``tp``, ``act_seq``, ``sp``) and the rank's index in it.
Where :func:`fit_spec` drops ``tp`` (the axis does not divide the
dimension) the parameter is whole on every model rank and its layer runs
unsplit.  A parameter may be cut on a storage and a ``tp`` dimension at
once (``wq`` is ``("fsdp", "tp", None)``).

The gradient rule: the ranks' objectives add up to the reference's one
loss (``models.layers.sharded_objective``), every cross-rank data flow
is a collective with its exact adjoint, and a parameter's gradient is
summed over the axes on which it is replicated, never over those that
shard it.  So Megatron's f/g pair (an input copy whose backward is an
all-reduce) is not used: with the sum over replicas it would count each
gradient ``model`` times.  A logical axis other than a storage or a
``tp`` one on a parameter raises ``NotImplementedError``.
:data:`COLLECTIVE_BYTES` counts the wire bytes of the collectives this
module runs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import TYPE_CHECKING, Any, NamedTuple

import torch

if TYPE_CHECKING:
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


def local_shard(x: "torch.Tensor", sharding: Sharding, coord=None
                ) -> "torch.Tensor":
    """This rank's block of the whole tensor ``x`` under ``sharding``
    (or the block at mesh coordinate ``coord``): what
    ``distribute_tensor(x, *sharding).to_local()`` holds, cut without a
    collective.  A dimension that its axes' sizes do not divide raises
    ``ValueError``, where ``NamedSharding`` refuses it (DTensor would
    pad)."""
    from torch.distributed.tensor import Shard

    mesh, place = sharding
    sizes = tuple(mesh_sizes(mesh).values())
    for d in range(x.ndim):
        n = math.prod(s for s, p in zip(sizes, place)
                      if isinstance(p, Shard) and p.dim == d)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of a {tuple(x.shape)} tensor "
                             f"does not divide into {n} shards")
    coord = mesh.get_coordinate() if coord is None else coord
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            step = x.shape[p.dim] // sizes[i]
            x = x.narrow(p.dim, int(coord[i]) * step, step)
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
        import numpy as np
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{names}")
        me = dist.get_rank()
        # the rows from the mesh's shape, with numpy: ``mesh.mesh`` is
        # built by tensor ops, which a fake tensor mode would intercept
        shape = tuple(mesh_sizes(mesh).values())
        if tuple(mesh.get_coordinate()) != np.unravel_index(me, shape):
            raise ValueError(f"rank {me} sits at {mesh.get_coordinate()} of "
                             f"a {shape} mesh: not its ranks 0..n-1 in "
                             "row-major order")
        rest = [i for i in range(len(names)) if i not in dims]
        rows = np.arange(math.prod(shape)).reshape(shape).transpose(
            *rest, *dims).reshape(-1, axes_size(mesh, axes)).tolist()
        for ranks in rows:
            if ranks != sorted(ranks):
                raise ValueError(f"mesh ranks {ranks} along {axes} are not "
                                 "ascending: a group orders its ranks so")
            group = dist.new_group(ranks)
            if me in ranks:
                _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def clear_groups() -> None:
    """Forget the groups :func:`axes_group` made (their process group
    was destroyed: the dry run makes a new one for each cell)."""
    _GROUPS.clear()


def spec_tree_to_shardings(rules: MeshRules, spec_tree):
    """A tree (dicts and lists) of mesh-axis spec tuples -> the same tree
    of :class:`Sharding`."""
    return spec_map(rules.named, spec_tree)


# --------------------------------------------------------------------------
# fitted specs and sharded trees
# --------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry(axes: tuple):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def fit_spec(rules: MeshRules, spec: tuple, shape) -> tuple:
    """``spec`` (mesh axes per dimension) with each dimension's trailing
    axes dropped from the first one whose size, times those before it,
    does not divide the dimension (zamba's 32000 vocabulary over 512-way
    FSDP keeps 32 ways): the reference's ``_fit_spec``."""
    sizes = mesh_sizes(rules.mesh)
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is None or d >= len(shape):
            out.append(entry)
            continue
        keep, prod = [], 1
        for a in _axes(entry):
            if shape[d] % (prod * sizes[a]):
                break
            keep.append(a)
            prod *= sizes[a]
        out.append(_entry(tuple(keep)))
    return tuple(out)


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of dicts and lists shaped
    alike (a spec tuple is a leaf)."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_tree_map2(fn, v, w) for v, w in zip(a, b)]
    return fn(a, b)


def spec_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists (a spec tuple
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v) for v in tree]
    return fn(tree)


def fitted(rules: MeshRules, logical: tuple, shape) -> tuple:
    """The mesh axes of each dimension of a ``shape`` leaf whose logical
    spec is ``logical``, fitted (:func:`fit_spec`)."""
    return fit_spec(rules, rules.spec(*logical), shape)


def resolve_tree(rules: MeshRules, spec_tree, shapes_tree=None):
    """A tree of logical specs -> the same tree of :class:`Sharding`,
    each fitted to its leaf of ``shapes_tree`` when that is given: the
    reference's ``resolve_tree``."""
    if shapes_tree is None:
        return spec_map(lambda s: rules.named(rules.spec(*s)), spec_tree)
    return _tree_map2(lambda s, x: rules.named(fitted(rules, s, x.shape)),
                      spec_tree, shapes_tree)


def shard_tree(tree, spec_tree, rules: MeshRules):
    """This rank's block of each whole leaf of ``tree`` (dicts and lists
    of tensors) under its logical spec in ``spec_tree``, fitted to the
    leaf: fresh tensors, so the whole leaves can be freed."""
    return _tree_map2(
        lambda x, s: local_shard(x, rules.named(fitted(rules, s, x.shape))
                                 ).clone(), tree, spec_tree)


def gather_tree(tree, spec_tree, shapes_tree, rules: MeshRules):
    """The inverse of :func:`shard_tree`: each whole leaf (its shape in
    ``shapes_tree``, meta tensors will do) reassembled on every rank from
    the ranks' blocks in ``tree``, by one all-gather per sharding mesh
    axis, the minor axis first."""
    def whole(x, pair):
        s, shape = pair
        return gather_whole(x, fitted(rules, s, shape.shape), rules)
    return _tree_map2(whole, tree, _tree_map2(lambda s, x: (s, x),
                                              spec_tree, shapes_tree))


def gather_whole(x: torch.Tensor, spec: tuple, rules: MeshRules
                 ) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under the
    fitted mesh-axis ``spec``; no autograd."""
    names = rules.all_axes
    dims = {a: d for d, e in enumerate(spec) for a in _axes(e)}
    for a in sorted(dims, key=names.index, reverse=True):
        if mesh_sizes(rules.mesh)[a] > 1:
            x = all_gather_dim(x, dims[a], rules.mesh.get_group(a))
    return x


def reshard(x: torch.Tensor, logical: tuple, shape, src: MeshRules,
            dst: MeshRules) -> torch.Tensor:
    """This rank's block under ``dst`` of the whole ``shape`` tensor whose
    block under ``src`` is ``x`` (the whole tensor gathered, then cut)."""
    whole = gather_whole(x, fitted(src, logical, shape), src)
    return local_shard(whole, dst.named(fitted(dst, logical, shape))
                       ).clone()


# --------------------------------------------------------------------------
# collectives, with their wire bytes counted
# --------------------------------------------------------------------------

# wire bytes a rank moved, by collective (the kinds of ``wire_bytes``)
COLLECTIVE_BYTES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


def wire_bytes(kind: str, result_bytes: int, n: int) -> int:
    """The bytes one rank of a group of ``n`` puts on the wire for a
    collective whose result on that rank is ``result_bytes``, by the
    reference's ring factors (``repro/launch/dryrun.py::
    collective_bytes``): all-gather (n-1)/n of its result, reduce-
    scatter (n-1) times its result (the shard: (n-1)/n of its input),
    all-reduce 2 (n-1)/n of its result, all-to-all (n-1)/n of it, a
    permute (a broadcast) its result.  ``kind`` is spelled with either
    ``_`` or ``-``; whole bytes, rounded down.  The one definition:
    :data:`COLLECTIVE_BYTES` and ``launch.op_analysis`` both count by
    it."""
    kind = kind.replace("_", "-")
    if n <= 1:
        return 0
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) // n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) // n
    if kind in ("collective-permute", "broadcast"):
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


def reset_collective_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


def _count(kind: str, result_bytes: int, n: int) -> None:
    COLLECTIVE_BYTES[kind] += wire_bytes(kind, result_bytes, n)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated on ``dim`` in group-rank
    order (the reference's tiled ``all_gather``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    _count("all_gather", n * x.numel() * x.element_size(), n)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block of it on
    ``dim`` (the reference's tiled ``psum_scatter``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    _count("reduce_scatter", out.numel() * out.element_size(), n)
    return out


def reduce_op(name: str):
    """``torch.distributed.ReduceOp`` by name (``"sum"``, ``"max"``)."""
    import torch.distributed as dist
    return getattr(dist.ReduceOp, name.upper())


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """``x`` summed (or ``op``) over the group, in place."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    _count("all_reduce", x.numel() * x.element_size(), n)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather_dim` with autograd: its backward reduce-scatters
    the gradient on ``dim``.  The group is kept for the backward, which
    may run on autograd's own thread.  ``group`` None: ``x``."""
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`reduce_scatter_dim` with autograd: its backward all-gathers
    the gradient on ``dim``.  ``group`` None: ``x``."""
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` (a new tensor) with autograd: its
    backward sums the gradient over the group.  ``group`` None: ``x``."""
    return x if group is None else _AllReduce.apply(x, group)


class AxisGroup(NamedTuple):
    """The ranks over some mesh axes: their process group, how many they
    are and this rank's index among them (row-major over the axes)."""
    group: Any
    size: int
    index: int


def logical_group(rules: "MeshRules | None", logical) -> AxisGroup | None:
    """The group over the mesh axes larger than 1 that the logical axis
    ``logical`` resolves to under ``rules`` (manual axes dropped), or
    None where they span one rank or no rules are active."""
    if rules is None:
        return None
    sizes = mesh_sizes(rules.mesh)
    axes = tuple(a for a in _axes(rules.resolve(logical)) if sizes[a] > 1)
    if not axes:
        return None
    names, coord = rules.all_axes, rules.mesh.get_coordinate()
    index = 0
    for a in axes:
        index = index * sizes[a] + int(coord[names.index(a)])
    return AxisGroup(axes_group(rules.mesh, axes), axes_size(rules.mesh,
                                                             axes), index)


def tp_group(whole: int, local: int) -> AxisGroup | None:
    """The ``tp`` group of the active rules when a layer's split dimension
    of ``whole`` entries holds ``local`` on this rank (its weights are
    the rank's slice), else None: the layer runs unsplit."""
    if local == whole:
        return None
    group = logical_group(_ACTIVE.get(), "tp")
    if group is None or local * group.size != whole:
        raise ValueError(f"a slice of {local} of {whole} entries where the "
                         "active rules split none over the model axis")
    return group


def seq_slice(x: torch.Tensor, dim: int, group: AxisGroup | None
              ) -> torch.Tensor:
    """This rank's block of ``x`` on ``dim`` among ``group``'s ranks (the
    residual stream's ``act_seq`` cut); ``x`` when ``group`` is None.  A
    length the group does not divide raises ``ValueError``."""
    if group is None:
        return x
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"sequence of {n} does not divide over the "
                         f"{group.size} ranks of the model axis")
    step = n // group.size
    return x.narrow(dim, group.index * step, step)


# --------------------------------------------------------------------------
# FSDP execution: parameters gathered at use
# --------------------------------------------------------------------------


class ParamLayout(NamedTuple):
    """Where a parameter's block lies: its storage dimension (None when
    not stored sharded) and that dimension's mesh axes, each larger than
    1; the other active axes larger than 1 that neither store nor split
    it (``rest``), over which its gradient is all-reduced; its whole
    shape; and its tensor-parallel dimension and axes (None, ()), which
    are never gathered."""
    dim: int | None
    axes: tuple
    rest: tuple
    shape: tuple
    tp_dim: int | None = None
    tp_axes: tuple = ()


# the logical axes that may shard a parameter's storage
_STORAGE = ("fsdp", "fsdp_expert")


def active_axes(rules: MeshRules) -> tuple:
    """The mesh axes larger than 1 that ``rules`` does not hold manual."""
    sizes = mesh_sizes(rules.mesh)
    return tuple(a for a in rules.all_axes
                 if a not in rules.manual_axes and sizes[a] > 1)


def param_layout(rules: MeshRules, logical: tuple, shape) -> ParamLayout:
    """The layout of a ``shape`` parameter with logical spec ``logical``
    under ``rules``: its spec resolved and fitted.  At most one storage
    dimension (``fsdp`` / ``fsdp_expert``) and one ``tp`` dimension may
    land on axes larger than 1.  Raises ``NotImplementedError`` where
    another logical axis does, or where two dimensions of one kind do."""
    sizes = mesh_sizes(rules.mesh)
    spec = fitted(rules, logical, shape)
    stored, split = [], []
    for d, (name, entry) in enumerate(zip(logical, spec)):
        axes = tuple(a for a in _axes(entry) if sizes[a] > 1)
        if not axes:
            continue
        if name not in (*_STORAGE, "tp"):
            raise NotImplementedError(
                f"logical axis {name!r} of a {tuple(shape)} parameter lands "
                f"on mesh axes {axes}: only storage and tensor-parallel "
                "dimensions are realised")
        (split if name == "tp" else stored).append((d, axes))
    if len(stored) > 1 or len(split) > 1:
        raise NotImplementedError(f"a {tuple(shape)} parameter sharded on "
                                  f"two dimensions {stored + split}")
    dim, axes = stored[0] if stored else (None, ())
    tp_dim, tp_axes = split[0] if split else (None, ())
    rest = tuple(a for a in active_axes(rules)
                 if a not in axes and a not in tp_axes)
    return ParamLayout(dim, axes, rest, tuple(shape), tp_dim, tp_axes)


def block_shape(layout: ParamLayout, mesh) -> tuple:
    shape = list(layout.shape)
    for d, axes in ((layout.dim, layout.axes),
                    (layout.tp_dim, layout.tp_axes)):
        if d is not None:
            shape[d] //= axes_size(mesh, axes)
    return tuple(shape)


def mark_sharded(p: torch.Tensor, logical: tuple, shape) -> None:
    """Mark ``p`` as the block of a whole ``shape`` parameter with
    logical spec ``logical``: :func:`gathered` then gathers it."""
    p.fsdp_spec = tuple(logical)
    p.fsdp_shape = tuple(shape)


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "fsdp_spec", None) is not None


def layout_of(p: torch.Tensor, rules: MeshRules) -> ParamLayout:
    """A marked parameter's layout under ``rules``; its block's shape
    must be the layout's."""
    layout = param_layout(rules, p.fsdp_spec, p.fsdp_shape)
    want = block_shape(layout, rules.mesh)
    if tuple(p.shape) != want:
        raise ValueError(f"a block of shape {tuple(p.shape)} where the "
                         f"rules cut {layout.shape} into {want}")
    return layout


class GatherParam(torch.autograd.Function):
    """Forward: the parameter whole on its storage dimension, its block
    all-gathered (tiled) there; a ``tp`` dimension stays the rank's
    slice.  Backward: the gradient reduce-scattered to the block, then
    all-reduced over the layout's ``rest``."""

    @staticmethod
    def forward(ctx, block, layout: ParamLayout, mesh):
        ctx.layout, ctx.mesh = layout, mesh
        if layout.dim is None:
            return block.view_as(block)
        return all_gather_dim(block, layout.dim,
                              axes_group(mesh, layout.axes))

    @staticmethod
    def backward(ctx, grad):
        layout, mesh = ctx.layout, ctx.mesh
        if layout.dim is not None:
            grad = reduce_scatter_dim(grad, layout.dim,
                                      axes_group(mesh, layout.axes))
        if layout.rest:
            grad = all_reduce_(grad.contiguous().clone(),
                               axes_group(mesh, layout.rest))
        return grad, None, None


_GATHERED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_fsdp_gathered", default=False)


def in_gathered() -> bool:
    """True inside :func:`gathered` on sharded parameters: the weights a
    layer sees are whole on their storage dimension (a ``tp`` dimension
    stays the rank's slice) while its activations are the rank's own."""
    return _GATHERED.get()


@contextlib.contextmanager
def gathered(module, *names: str):
    """For the length of the block, each marked parameter of ``module``
    (those named in ``names``, if any) is replaced in its module by its
    tensor gathered on its storage dimension through
    :class:`GatherParam` under the active rules.  Unmarked parameters
    stay; with none marked this is a no-op.  Used inside a ``remat``
    region, the backward's recompute gathers again."""
    marked = [(n, p) for n, p in module.named_parameters()
              if is_sharded(p) and (not names or n in names)]
    if not marked:
        yield module
        return
    rules = _ACTIVE.get()
    if rules is None:
        raise ValueError("sharded parameters need active MeshRules")
    swaps = []
    try:
        for name, p in marked:
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner)
            whole = GatherParam.apply(p, layout_of(p, rules), rules.mesh)
            swaps.append((mod, leaf, p))
            mod._parameters[leaf] = whole
        token = _GATHERED.set(True)
        try:
            yield module
        finally:
            _GATHERED.reset(token)
    finally:
        for mod, leaf, p in swaps:
            mod._parameters[leaf] = p


def norm_group(p: torch.Tensor, rules: MeshRules | None):
    """The group over which a parameter's block's sum of squares adds
    up to the whole's: its storage and ``tp`` axes (None: the rank holds
    it whole)."""
    if rules is None or not is_sharded(p):
        return None
    layout = layout_of(p, rules)
    axes = set(layout.axes) | set(layout.tp_axes)
    if not axes:
        return None
    return axes_group(rules.mesh, tuple(a for a in rules.all_axes
                                        if a in axes))


def objective_group(rules: MeshRules):
    """(group over the active axes or None, its size, how many of its
    ranks hold each block of the batch): the ranks whose objectives add
    up to one loss."""
    axes = active_axes(rules)
    n = axes_size(rules.mesh, axes) if axes else 1
    dp = tuple(a for a in _axes(rules.resolve("dp")) if a in axes)
    dup = n // (axes_size(rules.mesh, dp) if dp else 1)
    return (axes_group(rules.mesh, axes) if axes else None), n, dup
