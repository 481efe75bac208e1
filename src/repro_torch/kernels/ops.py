"""Public wrappers around the port's kernels, with the reference's
contract (``repro.kernels.ops``).

The tensor's device decides the route: a CUDA tensor goes through the
kernel (``bitunpack``, ``filter_agg``, ``block_agg``), a CPU tensor
through the kernel's plain PyTorch version.  uint32 words are carried
as int32 tensors of the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitunpack as _bu
from repro_torch.kernels import block_agg as _ba
from repro_torch.kernels import filter_agg as _fa


def bitunpack_tokens(words: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(B, G, bits) packed batch -> (B, G*32) int32 tokens.

    Requires G % 4 == 0 (seq_len % 128 == 0), as the reference does; the
    port's kernel would not need it, the contract keeps it."""
    B, G, b = words.shape
    if b != bits or G % 4:
        raise ValueError(f"bad packed shape {tuple(words.shape)}")
    out = _bu.bitunpack_groups(words.reshape(B * G, bits), bits, B * G * 32)
    return out.reshape(B, G * 32)


def filter_aggregate(values: torch.Tensor, filter_col: torch.Tensor,
                     cmp: str, threshold, *,
                     block_rows: int = _fa.DEFAULT_BLOCK_ROWS) -> dict:
    """Fused filter + agg over (N,) columns, any N: {"sum", "count",
    "min", "max"} as 0-dim float32 tensors.  Rows of the ragged last tile
    past N fail the predicate, for every comparator."""
    return _fa.combine_partials(_fa.filter_agg(
        values, filter_col, cmp, threshold, block_rows=block_rows))


def masked_aggregate(values: torch.Tensor, mask: torch.Tensor, *,
                     block_rows: int = _ba.DEFAULT_BLOCK_ROWS) -> dict:
    """[sum, count, min, max] of ``values`` where ``mask != 0``, any N."""
    return _fa.combine_partials(_ba.block_agg(values, mask,
                                              block_rows=block_rows))
