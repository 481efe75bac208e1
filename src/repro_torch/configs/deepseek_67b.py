"""DeepSeek-67B — llama-architecture dense LM (deep: 95 layers).

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base; verified-tier: hf]
95L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=102400.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention="gqa",
    source="arXiv:2401.02954; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek_67b_smoke",
    family="dense",
    n_layers=3,            # odd layer count, like 95
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=352,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="gqa",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
