"""Grok-1 (314B) — MoE LM, 8 experts top-2.

[hf:xai-org/grok-1; verified-tier: unverified]
64L, d_model=6144, 48 heads (GQA kv=8), expert d_ff=32768, vocab=131072.
With gated MLPs the analytic total is ~314B params (ArchConfig.param_count).
"""

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention="gqa",
    moe=MoEConfig(
        n_routed=8,
        n_shared=0,
        top_k=2,
        d_ff_expert=32768,
        first_dense=0,
    ),
    source="hf:xai-org/grok-1; unverified",
    # 314B params on 256 x 16 GB: fp32 Adam moments alone would be
    # 9.8 GB/chip — bf16 moments keep the train state under 10 GB/chip
    # (stochastic-rounding caveat recorded in EXPERIMENTS.md).
    opt_dtype=torch.bfloat16,
)

SMOKE_CONFIG = ArchConfig(
    name="grok1_314b_smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="gqa",
    moe=MoEConfig(
        n_routed=4,
        n_shared=0,
        top_k=2,
        d_ff_expert=64,
        first_dense=0,
    ),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
