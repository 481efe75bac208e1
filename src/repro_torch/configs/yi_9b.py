"""Yi-9B — llama-architecture dense LM with GQA.

[arXiv:2403.04652; hf:01-ai/Yi-9B; verified-tier: hf]
48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
RMSNorm + gated-SiLU MLP + RoPE (theta 5e6 per the Yi release).
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi_9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    attention="gqa",
    source="arXiv:2403.04652; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="yi_9b_smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=320,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="gqa",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
