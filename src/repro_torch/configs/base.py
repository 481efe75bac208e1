"""Architecture / run configuration system.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the full published configuration) and ``SMOKE_CONFIG`` (a reduced
same-family configuration used by CPU smoke tests).  ``registry()`` resolves
``--arch <id>`` names for the launchers.

Input shapes are global: each architecture is paired with the LM shape set
(train_4k / prefill_32k / decode_32k / long_500k); ``supported_shapes``
filters out ``long_500k`` for pure full-attention families per the
assignment (recorded in DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Mapping

import torch

# --------------------------------------------------------------------------
# Input shapes (assignment-defined; global_batch x seq_len per cell).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------
# Architecture config.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0          # routed experts
    n_shared: int = 0          # always-on shared experts
    top_k: int = 0
    d_ff_expert: int = 0       # per-expert FFN width
    first_dense: int = 0       # leading dense layers (deepseek-v2 style)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0       # 0 => direct q projection (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # mamba2 P / rwkv head size
    chunk: int = 256           # SSD / wkv chunk length
    # zamba-style hybrid: apply one weight-shared attention block every
    # `attn_every` ssm layers (0 = never).
    attn_every: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    act: str = "silu_gated"    # silu_gated | gelu
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    attention: str = "gqa"     # gqa | mla | none (attention-free)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    frontend: str = "none"     # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0  # patch/frame positions supplied pre-embedded
    tie_embeddings: bool = False
    source: str = ""           # provenance tag ([arXiv/hf; tier])

    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    opt_dtype: Any = torch.float32

    # ----------------------------------------------------------------
    @property
    def quadratic_attention(self) -> bool:
        """True when every token attends over the full prefix via softmax
        attention (i.e. no sub-quadratic path exists)."""
        if self.attention == "none":
            return False
        if self.ssm is not None and self.ssm.attn_every:
            return False  # hybrid: SSM backbone, periodic attention
        return True

    @property
    def supported_shapes(self) -> tuple[str, ...]:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if not self.quadratic_attention:
            names.append("long_500k")
        return tuple(names)

    # ----------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once unless tied)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "mla":
            assert self.mla is not None
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * self.n_heads * qk_head  # q proj (direct, lite)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down
            per_layer += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)  # kv up
            per_layer += self.n_heads * m.v_head_dim * d  # o proj
        elif self.attention == "gqa":
            per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            per_layer += self.n_heads * self.head_dim * d
        # FFN
        ff_mult = 3 if self.act == "silu_gated" else 2
        if self.moe is not None:
            experts = self.moe.n_routed + self.moe.n_shared
            per_layer += experts * ff_mult * d * self.moe.d_ff_expert
            per_layer += d * self.moe.n_routed  # router
            dense_ff = self.moe.first_dense * ff_mult * d * self.d_ff
        else:
            per_layer += ff_mult * d * self.d_ff
            dense_ff = 0
        if self.ssm is not None and self.attention != "none":
            # hybrid: per_layer above counted attention for every layer; the
            # shared block is counted once instead.
            pass
        if self.family in ("ssm", "hybrid"):
            per_layer = self._ssm_layer_params()
            shared = 0
            if self.ssm and self.ssm.attn_every:
                shared = (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                          + self.n_heads * self.head_dim * d
                          + ff_mult * d * self.d_ff)
            return emb + L * per_layer + shared
        return emb + L * per_layer + dense_ff

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":  # rwkv6: tmix ~4*d*d + cmix ~2*d*ff-ish
            return 4 * d * d + 2 * d * self.d_ff + 6 * d
        assert self.ssm is not None
        d_in = self.ssm.expand * d
        n_heads = d_in // self.ssm.head_dim
        # mamba2: in_proj (z,x,B,C,dt) + out_proj + conv + A,D
        zx = 2 * d_in
        bc = 2 * self.ssm.d_state  # B, C (single group)
        return d * (zx + bc + n_heads) + d_in * d + self.ssm.d_conv * (
            d_in + 2 * self.ssm.d_state) + 2 * n_heads

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k routed)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ff_mult = 3 if self.act == "silu_gated" else 2
        full = self.param_count()
        experts_all = (self.moe.n_routed + self.moe.n_shared) * ff_mult * d * \
            self.moe.d_ff_expert * self.n_layers
        experts_active = (self.moe.top_k + self.moe.n_shared) * ff_mult * d * \
            self.moe.d_ff_expert * self.n_layers
        return full - experts_all + experts_active


# --------------------------------------------------------------------------
# Registry.
# --------------------------------------------------------------------------

ARCH_IDS = (
    "starcoder2_7b",
    "yi_9b",
    "deepseek_67b",
    "granite_20b",
    "deepseek_v2_lite_16b",
    "grok1_314b",
    "zamba2_2p7b",
    "musicgen_large",
    "rwkv6_3b",
    "pixtral_12b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def registry() -> dict[str, ArchConfig]:
    out = {}
    for arch_id in ARCH_IDS:
        mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
        out[arch_id] = mod.CONFIG
    return out


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    arch_id = _ALIASES.get(name, name)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
