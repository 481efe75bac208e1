"""MusicGen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf:facebook/musicgen-large; verified-tier: hf]
48L, d_model=2048, 32 heads (MHA), d_ff=8192, vocab=2048 (EnCodec codebook).

Backbone only per the assignment: the EnCodec frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, S, d_model)
instead of raw audio; the LM head predicts codebook tokens (vocab 2048).
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,           # 2048 / 32
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    attention="gqa",
    frontend="audio_stub",
    source="arXiv:2306.05284; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="musicgen_large_smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=128,
    act="gelu",
    norm="layernorm",
    attention="gqa",
    frontend="audio_stub",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
