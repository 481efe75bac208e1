"""StarCoder2-7B — dense code LM with GQA + RoPE.

[arXiv:2402.19173; hf:bigcode/starcoder2-7b; verified-tier: hf]
32L, d_model=4608, 36 heads (GQA kv=4), d_ff=18432, vocab=49152.
StarCoder2 uses non-gated GELU MLPs and LayerNorm.

TP note: 36 heads % 16 != 0, so the sharding rules shard head_dim (128)
over the model axis for this arch (DESIGN.md §5).
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    rope_theta=100_000.0,
    attention="gqa",
    source="arXiv:2402.19173; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="starcoder2_7b_smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,           # keep the H % mesh != 0 property in miniature
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    act="gelu",
    norm="layernorm",
    attention="gqa",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
