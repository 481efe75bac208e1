"""``perfbench.flops`` pinned to the counts the port's card runs printed
(4 x 4096 tokens a step) and to a hand count of a small prefill."""

import dataclasses
import json
from pathlib import Path

import pytest

from perfbench import flops
from perfbench.reference import lm

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def spec(name: str, layers: int) -> lm.Spec:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    return dataclasses.replace(lm.spec_from_config(cfg), n_layers=layers)


@pytest.mark.parametrize("name,layers,want", [
    ("deepseek_v2_lite_16b", 6, 7.561e13),     # the 6-layer MoE train phase
    ("starcoder2_7b", 4, 1.150e14),            # the 4-layer train phase
])
def test_train_flops_match_the_card_runs(name, layers, want):
    assert flops.train_flops(spec(name, layers), 4, 4096) == \
        pytest.approx(want, rel=5e-4)


def test_moe_counts_top_k_experts_not_capacity():
    s = spec("deepseek_v2_lite_16b", 2)
    dense, routed, head = flops.matmul_params(s)
    assert routed == 3 * 2048 * 1408        # one expert's w1, w3, w2, one layer
    more = dataclasses.replace(s, capacity_factor=8.0)
    assert flops.train_flops(more, 4, 4096) == flops.train_flops(s, 4, 4096)


def test_prefill_flops_by_hand():
    """Each prompt counts its own tokens and its own causal attention;
    the pads that batch prompts of 5 and 3 tokens to 5 count nowhere."""
    s = lm.Spec(vocab=10, d_model=4, n_layers=1, n_heads=2, n_kv_heads=1,
                head_dim=2, d_ff=8, mlp="gelu_tanh", norm="layernorm",
                norm_eps=1e-5, rope_theta=1e4, attention="gqa",
                param_dtype=None)
    # per layer: wq 4x2x2 + wk 4x1x2 + wv 4x1x2 + wo 2x2x4 + w1 4x8 + w2 8x4
    per_token = 16 + 8 + 8 + 16 + 32 + 32
    head = 4 * 10
    want = 0
    for n in (5, 3):
        attn = n * n * 2 * (2 + 2)          # q.k and p.v, causal half, x2
        want += 2 * n * per_token + 2 * head + attn
    assert flops.prefill_flops(s, [5, 3]) == want
    assert flops.prefill_flops(s, [5, 3]) < flops.prefill_flops(s, [5, 5])
