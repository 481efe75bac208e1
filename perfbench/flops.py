"""Model FLOPs of a train step and of a prefill, and the card's peak.

The FLOPs count what the model needs, not what an implementation runs:
of the routed experts, the ``top_k`` each token is sent to (never every
expert's capacity slots), and causal attention's half of each S x S
product.  They are computed from the configuration (``reference.lm.
Spec``), so they move only when the configuration does.
"""

from __future__ import annotations

from perfbench.reference.lm import Spec, param_layout

# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate at the 700 W
# limit (a card set below it runs slower; runs print the card's limit)
BF16_PEAK_FLOPS = 989e12


def matmul_params(spec: Spec) -> tuple[int, int, int]:
    """(parameters a token multiplies by outside the experts and the
    head, the routed experts' parameters of one expert slot summed over
    the expert layers, the head's) - the token embedding is a gather and
    counts nowhere; a norm scale or bias is not a product."""
    dense = routed = head = 0
    for leaf in param_layout(spec):
        n = 1
        for s in leaf.shape:
            n *= s
        if leaf.name == "embed.head":
            head = n
        elif leaf.name == "embed.tok" or not leaf.fan_in:
            continue
        elif ".moe.w" in leaf.name:
            routed += n // spec.n_routed
        else:
            dense += n
    return dense, routed, head


def attention_flops(spec: Spec, batch: int, seq: int) -> float:
    """Forward FLOPs of causal attention's two products over all layers:
    q.k over the q/k head width and p.v over the v head width, each
    2 x B x S x S x H x width, half of them masked."""
    if spec.attention == "mla":
        qk, vd = spec.qk_nope + spec.qk_rope, spec.v_head
    else:
        qk = vd = spec.head_dim
    return float(spec.n_layers * batch * seq * seq * spec.n_heads
                 * (qk + vd))


def train_flops(spec: Spec, batch: int, seq: int) -> float:
    """Model FLOPs of one train step on ``batch`` x ``seq`` tokens: 6 per
    multiplied parameter a token touches (the router, the shared
    experts and ``top_k`` routed experts; the head), and three times
    causal attention's forward products (forward and backward)."""
    dense, routed, head = matmul_params(spec)
    tokens = batch * seq
    return float(6 * tokens * (dense + head + spec.top_k * routed)
                 + 3 * attention_flops(spec, batch, seq))


def prefill_flops(spec: Spec, prompt_lens) -> float:
    """Model FLOPs of prefilling prompts of ``prompt_lens`` tokens, each
    its own: 2 per multiplied parameter a prompt token touches, each
    prompt's causal attention over its own length, and the head at its
    last position only.  Pad positions that an implementation adds to
    batch prompts together count nowhere."""
    dense, routed, head = matmul_params(spec)
    return float(sum(2 * n * (dense + spec.top_k * routed) + 2 * head
                     + attention_flops(spec, 1, n) for n in prompt_lens))
