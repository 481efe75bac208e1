"""Cost analysis of one rank's step, from the ATen ops it dispatches.

The counterpart of ``repro.launch.hlo_analysis``, which walks a
compiled program's HLO: the port has no HLO, so :class:`OpCounter`, a
``TorchDispatchMode``, sees every ATen operator one rank's step
dispatches (its forward, the autograd backward and recompute, the
optimizer; on fake tensors in the dry run, on real ones anywhere else)
and accumulates the keys of ``hlo_analysis.analyze``:

  flops       matrix products and convolutions, by the formulas of
              ``torch.utils.flop_counter`` (2 * m * n * k a product, as
              the reference's analyzer counts a ``dot``), the mixed
              product's ``mm.dtype`` / ``bmm.dtype`` (``layers.
              mixed_einsum``) as ``mm`` / ``bmm``, and the inference
              attention kernel's operator as the block loop's products
              (:func:`flash_fwd_flops`)
  bytes       per operator: its tensor operands read once and its
              results written once; views and metadata queries move
              nothing
  bytes_fused equal to ``bytes``: in eager PyTorch every operator's
              operands and results round-trip device memory (no
              fusion pass folds elementwise operators into their
              neighbours, as XLA's does)
  collective  wire bytes a rank moves, by kind, plus ``total``: the
              ``c10d`` collectives, each by ``sharding.wire_bytes`` (the
              reference's ring factors) over its group's size
  collective_count, dots
              how many collectives and products ran

and the memory of the step: the bytes of the live tensor storages (the
arguments registered with :meth:`OpCounter.track`, then every storage
an operator allocates, until it is freed) and their largest total,
``peak_bytes``.  Every rank runs the same code, so one rank's counts
are a device's.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed.sharding import wire_bytes
from repro_torch.models.attention import FLASH_BLOCK

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d operator -> (kind, whether it writes its result (its first
# argument) apart from its input (its second) or in place)
_C10D = {
    "allgather_": ("all-gather", True),
    "_allgather_base_": ("all-gather", True),
    "allgather_into_tensor_coalesced_": ("all-gather", True),
    "allreduce_": ("all-reduce", False),
    "allreduce_coalesced_": ("all-reduce", False),
    "reduce_scatter_": ("reduce-scatter", True),
    "_reduce_scatter_base_": ("reduce-scatter", True),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", True),
    "alltoall_": ("all-to-all", True),
    "alltoall_base_": ("all-to-all", True),
    "broadcast_": ("collective-permute", False),
}

# operators that read or write no tensor data (an allocation's storage
# is still live memory)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "device", "lift_fresh", "_local_scalar_dense",
         "is_same_size", "_has_compatible_shallow_copy_type"}


def _tensor_bytes(x) -> int:
    """The bytes of the tensors in ``x`` (a tensor, or lists, tuples and
    dicts of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


_VIEW, _FREE_OP, _C10D_OP, _COMPUTE = range(4)


def flash_fwd_flops(q, k, v, causal, q_offset, out_val=None) -> int:
    """``repro_torch::flash_fwd`` (``kernels.flash_fwd``) counted as the
    block loop it stands in for dispatched its products: for each
    (query block, key block) pair up to the diagonal, in blocks of
    ``attention.FLASH_BLOCK``, the scores (2 * bq * bk * hd a head) and
    the value product (2 * bq * bk * hdv), so a dry run's FLOPs do not
    depend on the route."""
    B, Sq, H, hd = q.shape
    Sk, hdv = v.shape[1], v.shape[-1]
    bq, bk = min(FLASH_BLOCK, Sq), min(FLASH_BLOCK, Sk)
    if not bq or not bk:
        return 0
    pairs = sum(1 for i in range(0, Sq, bq) for j in range(0, Sk, bk)
                if not (causal and j > q_offset + i + bq - 1))
    return 2 * B * H * bq * bk * (hd + hdv) * pairs


# the port's own operators that do products: their schema name -> formula
_OWN_FLOPS = {"repro_torch::flash_fwd": flash_fwd_flops}


def _without_dtype(formula):
    """A flop formula for an overload that adds an ``out_dtype``
    argument (``aten::bmm.dtype``): the formula of its packet, given the
    tensors' shapes alone."""
    def count(*args, **kwargs):
        kwargs.pop("out_dtype", None)
        return formula(*(a for a in args if not isinstance(a, torch.dtype)),
                       **kwargs)
    return count


def _classify(func) -> tuple:
    """(category, detail) of an operator, once per operator."""
    ns, _, op = func._schema.name.partition("::")
    if ns == "c10d":
        return (_C10D_OP, _C10D.get(op))
    if func.is_view:
        return (_VIEW, None)
    if op in _FREE:
        return (_FREE_OP, None)
    formula = flop_registry.get(func._overloadpacket) \
        or _OWN_FLOPS.get(func._schema.name)
    if formula is not None and any(a.name == "out_dtype"
                                   for a in func._schema.arguments):
        formula = _without_dtype(formula)
    return (_COMPUTE, formula)


def _group_size(func, args) -> int:
    """The size of the process group a ``c10d`` operator runs over (its
    argument of that type, a boxed ``ProcessGroup``)."""
    from torch.distributed import ProcessGroup

    for a, arg in zip(args, func._schema.arguments):
        if "ProcessGroup" in str(arg.type):
            return ProcessGroup.unbox(a).size()
    raise ValueError(f"{func}: a collective without its process group")


class OpCounter(TorchDispatchMode):
    """Counts what the operators dispatched under it do (the module
    docstring).  :meth:`result` returns the counts in
    ``hlo_analysis.analyze``'s keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.coll_count = 0
        self.dots = 0
        self.ops = 0
        self.calls: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._kinds: dict = {}

    # ------------------------------------------------------------ memory
    def track(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (the step's
        arguments, made before it) as live; returns their bytes."""
        return sum(self._hold(t) for t in tree_leaves(trees)
                   if isinstance(t, torch.Tensor))

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._storages:
            return 0
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    # ------------------------------------------------------------ ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        cat, detail = kind
        if cat == _VIEW:
            return out
        if cat == _C10D_OP:
            if detail is not None:
                name, apart = detail
                result = _tensor_bytes(args[0])
                self.coll[name] += wire_bytes(name, result,
                                              _group_size(func, args))
                self.coll_count += 1
                self.bytes += result + (_tensor_bytes(args[1]) if apart
                                        else result)
            return out
        for t in _tensors(out):
            self._hold(t)
        if cat == _FREE_OP:
            return out
        self.ops += 1
        self.calls[func] += 1
        if detail is not None:
            self.flops += detail(*args, **kwargs, out_val=out)
            self.dots += 1
        self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) \
            + _tensor_bytes(out)
        return out

    # ------------------------------------------------------------ result
    def result(self) -> dict:
        """The counts in ``hlo_analysis.analyze``'s keys, with the
        memory's ``peak_bytes`` and the number of operators counted
        (``calls`` has them by operator)."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "bytes_fused": float(self.bytes),
                "collective": dict(self.coll, total=sum(self.coll.values())),
                "collective_count": float(self.coll_count),
                "dots": float(self.dots), "ops": self.ops,
                "peak_bytes": self.peak_bytes}

