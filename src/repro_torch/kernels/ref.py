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
