"""Device data-plane pushdown: the paper's offload idea on the card.

The analogue of "the server that holds the object" is the device that
holds the shard: these helpers run objclass-style operators where a
shard lives and move only results, so the only bytes entering
collectives are the four partials of a filter -> agg.  The counterpart
of ``repro.core.pushdown_jax``.

Under torch SPMD every rank holds its local shard, where the
reference's ``shard_map`` took global arrays: with active mesh rules
(``distributed.sharding.use_rules``) each rank passes its shard, and the
partials are combined with ``torch.distributed.all_reduce`` over the
group of each data-parallel axis (SUM for sum and count, MIN for min and
for the negated max), in place of ``psum``/``pmin``/``pmax``.

``unpack_bitpacked`` is the storage codec's decode on the device:
objects hold planar-bitpacked tokens and the loader ships the words, so
the host -> device path carries bits/32 of the raw bytes.  On a CUDA
tensor it runs the ``bitunpack`` kernel; the reference kept a jnp form
for GSPMD, which the port has no use for (the values are bit-identical).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import bitunpack as _bu
from repro_torch.kernels import filter_agg as _fa


# --------------------------------------------------------------------------
# codec offload: planar bitunpack
# --------------------------------------------------------------------------


def unpack_bitpacked(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., G, bits) int32 planar words (uint32 bits) -> (..., G*32)
    int32 values, on the words' device (the kernel on a CUDA tensor)."""
    if words.dim() < 2 or words.shape[-1] != bits:
        raise ValueError(f"last dim {words.shape[-1]} != bits {bits}")
    lead, G = words.shape[:-2], words.shape[-2]
    flat = words.reshape(-1, bits)
    vals = _bu.bitunpack_groups(flat, bits, flat.shape[0] * 32)
    return vals.reshape(*lead, G * 32)


def packed_shape(n_values: int, bits: int) -> tuple[int, int]:
    """Shape of the packed representation of n_values values."""
    return (-(-n_values // 32), bits)


# --------------------------------------------------------------------------
# shard-local filter/aggregate
# --------------------------------------------------------------------------


def _partial_filter_agg(values: torch.Tensor, filter_col: torch.Tensor,
                        cmp: str, threshold) -> dict:
    """Per-shard objclass pipeline: filter(col cmp thr) -> agg partials.

    A CUDA shard goes through the ``filter_agg`` kernel, which compares
    in float32 as the reference's kernel does.  A CPU shard runs the
    reference's plain form, which compares in the filter's own dtype
    (the two differ only for integer filter values above 2^24)."""
    if values.device.type == "cuda":
        return _fa.combine_partials(
            _fa.filter_agg(values, filter_col, cmp, threshold))
    mask = _fa.PREDICATES[cmp](filter_col, threshold)
    vf = values.to(torch.float32)
    big = torch.tensor(_fa.BIG, dtype=torch.float32)
    return {"sum": torch.where(mask, vf, 0.0).sum(),
            "count": mask.to(torch.float32).sum(),
            "min": torch.where(mask, vf, big).amin(),
            "max": torch.where(mask, vf, -big).amax()}


def _all_reduce(partial: dict, rules: shd.MeshRules) -> dict:
    sums = torch.stack([partial["sum"], partial["count"]])
    ext = torch.stack([partial["min"], -partial["max"]])
    for axis in rules.dp_axes:
        group = rules.mesh.get_group(axis)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(ext, op=dist.ReduceOp.MIN, group=group)
    return {"sum": sums[0], "count": sums[1], "min": ext[0],
            "max": -ext[1]}


def pushdown_filter_aggregate(values: torch.Tensor, filter_col: torch.Tensor,
                              cmp: str, threshold) -> dict:
    """Distributed filter + aggregate with O(result) collective bytes:
    {"sum", "count", "min", "max"} as 0-dim float32 tensors.

    Without active rules it runs on the whole arrays.  With rules,
    ``values``/``filter_col`` are this rank's (N_local,) shards and every
    rank of the data-parallel axes gets the combined result."""
    partial = _partial_filter_agg(values, filter_col, cmp, threshold)
    rules = shd.active_rules()
    if rules is None or not rules.dp_axes:
        return partial
    return _all_reduce(partial, rules)


# --------------------------------------------------------------------------
# generic compute-at-shard combinator
# --------------------------------------------------------------------------


def shard_local(fn: Callable, *, out_specs=None, in_axes: str = "dp"):
    """Wrap ``fn(shard_inputs...) -> partials`` to run where the data
    shards live.  ``fn`` receives per-shard blocks and must emit already-
    combined outputs (``torch.distributed.all_reduce`` over
    ``active_rules().mesh.get_group(axis)`` for each data-parallel axis).

    The reference wraps ``fn`` in a ``shard_map``.  Under torch SPMD
    each rank already holds its shard and runs ``fn`` on it, so ``fn``
    itself is returned, with and without active rules; ``out_specs`` and
    ``in_axes`` are kept for the reference's signature.
    """
    del out_specs, in_axes
    return fn
