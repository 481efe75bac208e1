"""Granite-20B (code) — llama-style dense LM with MQA (single KV head).

[arXiv:2405.04324; hf:ibm-granite/granite-20b-code-base; verified-tier: hf]
52L, d_model=6144, 48 heads (kv=1, i.e. multi-query), d_ff=24576, vocab=49152.
Assignment classifies it llama-arch; we use RMSNorm + gated SiLU accordingly.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention="gqa",
    source="arXiv:2405.04324; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="granite_20b_smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=1,          # preserve the MQA property
    head_dim=16,
    d_ff=384,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="gqa",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
