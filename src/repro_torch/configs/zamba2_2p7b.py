"""Zamba2-2.7B — hybrid: Mamba2 backbone + periodic weight-SHARED attention.

[arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B; verified-tier: hf]
54 Mamba2 layers, d_model=2560, ssm_state=64; one shared attention+MLP block
(32 heads, MHA kv=32, d_ff=10240) applied every 6 SSM layers (9 applications,
one weight set).  vocab=32000.

Runs long_500k: the backbone is sub-quadratic; the shared attention block's
KV cache is sequence-sharded at decode.
"""

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2_2p7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,           # 2560 / 32
    d_ff=10240,
    vocab_size=32000,
    act="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention="gqa",
    ssm=SSMConfig(
        d_state=64,
        d_conv=4,
        expand=2,
        head_dim=64,
        chunk=256,
        attn_every=6,
    ),
    source="arXiv:2411.15242; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="zamba2_2p7b_smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    norm="rmsnorm",
    attention="gqa",
    ssm=SSMConfig(
        d_state=16,
        d_conv=4,
        expand=2,
        head_dim=16,
        chunk=16,
        attn_every=2,
    ),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
