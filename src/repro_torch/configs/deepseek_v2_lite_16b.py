"""DeepSeek-V2-Lite (16B) — MoE LM with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite; verified-tier: hf]
27L, d_model=2048, 16 heads, MLA kv_lora_rank=512 (no q-lora in Lite),
qk_nope=128 / qk_rope=64 / v=128 per head.  MoE: 64 routed experts top-6
+ 2 shared experts, expert d_ff=1408; the first layer is dense (d_ff=10944).

NOTE: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed
top-6"; 160 routed is the full DeepSeek-V2 figure — we follow the Lite
config (64 routed), recorded in DESIGN.md §4.
"""

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,          # v head dim (MLA overrides per-component dims)
    d_ff=10944,            # dense-layer FFN width (layer 0)
    vocab_size=102400,
    act="silu_gated",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=64,
        n_shared=2,
        top_k=6,
        d_ff_expert=1408,
        first_dense=1,
    ),
    source="arXiv:2405.04434; hf",
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b_smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    act="silu_gated",
    norm="rmsnorm",
    attention="mla",
    mla=MLAConfig(
        kv_lora_rank=32,
        q_lora_rank=0,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    moe=MoEConfig(
        n_routed=8,
        n_shared=1,
        top_k=2,
        d_ff_expert=32,
        first_dense=1,
        # no capacity drops at smoke scale so prefill == decode exactly
        # (the full config keeps the default 1.25)
        capacity_factor=8.0,
    ),
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
)
