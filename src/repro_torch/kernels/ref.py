"""Plain PyTorch oracles for the port's kernels, with the reference's
signatures (tests compare against them)."""

from __future__ import annotations

import torch


def bitunpack_ref(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, 4, bits) int32 (uint32 bits) -> (R, 128) int32."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    lane = torch.arange(32, dtype=torch.int64, device=w.device)
    sel = (w[..., None] >> lane) & 1                        # (R,4,b,32)
    weight = 1 << torch.arange(bits, dtype=torch.int64, device=w.device)
    vals = (sel * weight[None, None, :, None]).sum(dim=2)   # (R,4,32)
    vals = torch.where(vals >= 1 << 31, vals - (1 << 32), vals)
    return vals.reshape(words.shape[0], 128).to(torch.int32)


_PREDS = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
          "==": torch.eq, "!=": torch.ne}
_BIG = 3.4e38


def _masked_stats(v: torch.Tensor, m: torch.Tensor) -> dict:
    big = torch.tensor(_BIG, dtype=torch.float32, device=v.device)
    return {
        "sum": torch.where(m, v, 0.0).sum(),
        "count": m.to(torch.float32).sum(),
        "min": torch.where(m, v, big).amin(),
        "max": torch.where(m, v, -big).amax(),
    }


def filter_agg_ref(values: torch.Tensor, filter_col: torch.Tensor, cmp: str,
                   threshold: float) -> dict[str, torch.Tensor]:
    """Whole-column float32 [sum, count, min, max] under
    f32(filter) cmp f32(threshold)."""
    thr = torch.tensor(float(threshold), dtype=torch.float32,
                       device=filter_col.device)
    m = _PREDS[cmp](filter_col.to(torch.float32), thr)
    return _masked_stats(values.to(torch.float32), m)


def block_agg_ref(values: torch.Tensor, mask: torch.Tensor) -> dict:
    """Whole-column float32 [sum, count, min, max] where mask != 0."""
    return _masked_stats(values.to(torch.float32), mask != 0)
