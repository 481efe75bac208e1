"""Pixtral-12B — VLM: Pixtral-ViT frontend + Mistral-NeMo-style decoder.

[hf:mistralai/Pixtral-12B-2409; verified-tier: unverified]
40L, d_model=5120, 32 heads (GQA kv=8, head_dim=128 so H*hd=4096 != d_model),
d_ff=14336, vocab=131072.

Backbone only per the assignment: the vision tower is a STUB —
``input_specs()`` provides precomputed patch embeddings (B, P, d_model) that
occupy the first P positions of the sequence, with text tokens after them.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    attention="gqa",
    frontend="vision_stub",
    n_frontend_tokens=1024,   # precomputed patch-embedding positions
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

SMOKE_CONFIG = ArchConfig(
    name="pixtral_12b_smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,           # H*hd = 64 != d_model, like the real config
    d_ff=256,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="gqa",
    frontend="vision_stub",
    n_frontend_tokens=16,
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
