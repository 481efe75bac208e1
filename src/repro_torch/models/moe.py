"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch.

The counterpart of ``repro.models.moe``.  Tokens are sorted by expert,
packed into ``C`` slots per expert with gathers (no O(T^2) one-hot
dispatch), run through batched expert products, and combined back with
their gates.  The reference's sharded bodies (``_token_body``,
``_megatron_body``) gather the expert weights and reduce partials over
the FSDP and TP axes; on one card those axes have size 1 and each body
is ``_moe_math`` with ``reduce_axes=None``, so ``moe_ffn`` runs that
math whether or not ``MeshRules`` are active.

Where the port has to choose, it chooses the reference's numbers:

* top-k is a stable descending sort of the router's probabilities, cut
  to k: equal probabilities come lowest expert first, as
  ``jax.lax.top_k`` gives them (``torch.topk`` promises no order).
* the dispatch sort is ``argsort(stable=True)``, as ``jnp.argsort``, so
  each expert's segment keeps token order; segment starts come from
  ``searchsorted(side="left")``.
* the dispatch copies each kept entry into its slot of an ``(E*C + 1,
  D)`` buffer whose last row takes every dropped entry and is cut off:
  kept slots are unique, so this is the reference's scatter with
  ``mode="drop"``.
* the combine gathers each token's ``top_k`` gated rows to ``(T, k,
  D)`` and adds them one after the other in ascending expert order,
  starting from the first: the order in which the reference's
  scatter-add meets them in its expert-sorted updates, and a fixed
  order on the card (``index_add_`` there is atomic and is not).
* gates are cast to the values' dtype before the multiply, and every
  expert computes all its ``C`` slots, full or not, so a decode step
  (T = B, C = 8) reads every routed expert's weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _param


def init_moe(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    m, d = cfg.moe, cfg.d_model
    dt = cfg.param_dtype
    E, Fe = m.n_routed, m.d_ff_expert
    params = {
        "router": _param((d, E), torch.float32, device),
        "w1": _param((E, d, Fe), dt, device),
        "w3": _param((E, d, Fe), dt, device),
        "w2": _param((E, Fe, d), dt, device),
    }
    if m.n_shared:
        Fs = m.n_shared * Fe   # fused shared experts (mathematically identical)
        params.update({"sw1": _param((d, Fs), dt, device),
                       "sw3": _param((d, Fs), dt, device),
                       "sw2": _param((Fs, d), dt, device)})
    return nn.ParameterDict(params)


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.n_routed * m.capacity_factor)
    return max(8, min(n_tokens, (c + 7) // 8 * 8))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, largest first, equal
    values lowest index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_math(cfg: ArchConfig, x: torch.Tensor, router, w1, w3, w2,
              shared):
    """Routing and expert compute.  x: (T, D).  Returns (out (T, D),
    aux, zloss), the losses 0-d float32."""
    m = cfg.moe
    T, D = x.shape
    E, k = m.n_routed, m.top_k
    C = _capacity(T, cfg)
    dev = x.device

    # ---- routing (float32) ----
    logits = x.float() @ router                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                     # (T, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses ----
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    frac_routed = counts / (T * k)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(frac_routed * mean_prob) * m.aux_loss_coef
    zloss = torch.logsumexp(logits, dim=-1).square().mean() \
        * m.router_z_coef

    # ---- sort-based dispatch ----
    n = T * k
    e_flat = idx.reshape(-1)                          # (T*k,)
    ar = torch.arange(n, device=dev)
    order = torch.argsort(e_flat, stable=True)        # groups by expert
    sorted_e = e_flat[order]
    sorted_tok = order // k                           # token of each entry
    sorted_gate = gates.reshape(-1)[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = ar - first
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # E*C: dropped

    buf = x.new_zeros((E * C + 1, D)).index_copy(0, slot, x[sorted_tok])
    buf = buf[:E * C].reshape(E, C, D)

    # ---- expert compute ----
    h = torch.bmm(buf, w1)
    g = torch.bmm(buf, w3)
    h = F.silu(g) * h
    out_buf = torch.bmm(h, w2).reshape(E * C, D)

    # ---- combine: each token's k gated rows, ascending expert order ----
    padded = torch.cat([out_buf, out_buf.new_zeros((1, D))])
    vals = padded[slot]
    vals = vals * (sorted_gate * keep).to(vals.dtype)[:, None]
    where = torch.empty_like(order)
    where[order] = ar                                 # entry -> sorted place
    rows = vals[where.reshape(T, k).sort(dim=1).values]   # (T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]

    # ---- shared experts (dense path, fused) ----
    if shared:
        sw1, sw3, sw2 = shared
        hs = F.silu(x @ sw3) * (x @ sw1)
        out = out + hs @ sw2
    return out, aux, zloss


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux + zloss)."""
    B, S, D = x.shape
    shared = tuple(p[k] for k in ("sw1", "sw3", "sw2") if k in p)
    out, aux, zloss = _moe_math(cfg, x.reshape(B * S, D), p["router"],
                                p["w1"], p["w3"], p["w2"], shared or None)
    return out.reshape(B, S, D).to(x.dtype), aux + zloss
