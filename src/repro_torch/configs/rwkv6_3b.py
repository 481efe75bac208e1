"""RWKV6-3B ("Finch") — attention-free RNN LM with data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b; verified-tier: hf]
32L, d_model=2560 (40 heads of size 64), d_ff=8960, vocab=65536.

Runs long_500k: decode is O(1)-state (per-head 64x64 wkv state), no KV cache.
"""

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6_3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads (d_model / 64)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    act="relu_sq",         # rwkv channel-mix uses squared relu
    norm="layernorm",
    attention="none",
    ssm=SSMConfig(
        d_state=64,        # state is head_dim x head_dim per head
        head_dim=64,
        chunk=16,  # tuned: EXPERIMENTS §Perf C'2 (bytes ~ c; c=16 is -19% bound)
    ),
    source="arXiv:2404.05892; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="rwkv6_3b_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=224,
    vocab_size=256,
    act="relu_sq",
    norm="layernorm",
    attention="none",
    ssm=SSMConfig(
        d_state=16,
        head_dim=16,
        chunk=16,
    ),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
