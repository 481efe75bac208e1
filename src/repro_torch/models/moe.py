"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch.

The counterpart of ``repro.models.moe``.  Tokens are sorted by expert,
packed into ``C`` slots per expert with gathers (no O(T^2) one-hot
dispatch), run through batched expert products, and combined back with
their gates.  Dispatch is shard-local: under active ``MeshRules`` whose
mesh has an axis larger than 1, ``moe_ffn`` takes the reference's
sharded paths by strategy, each rank holding its local tokens and
weight blocks:

  token path (fsdp / fsdp_dp / tp_dp / tp_sp) — the rank's tokens; if
      the experts' F is split over the model axis (``w1`` / ``w3`` /
      ``w2`` and the shared experts' hold the rank's F slice), the
      partials, routed and shared together, all-reduced once at the end.
  megatron path (megatron_sp) — the residual stream sequence-sharded
      over the model axis: the sequence all-gathered once, every model
      rank routing the same tokens with its F slice, the output
      reduce-scattered back on the sequence.

The weights' storage blocks (``fsdp_expert``) are gathered through
``sharding.GatherParam``, or arrive gathered already inside
``sharding.gathered`` (the train step and serving on a sharded model);
the token collectives are ``sharding``'s autograd collectives, so both
bodies train.  Each body computes ``C`` from the rank's own token
count, as the reference does inside its ``shard_map``.  ``aux`` and
``zloss`` are the mean over the ``fsdp_expert`` group where the body
gathers its weights itself; inside ``gathered`` each rank returns its
own, which the loss averages over the ranks
(``layers.sharded_objective``), the same mean.  When every mesh axis
has size 1, or no rules are active, ``moe_ffn`` is ``_moe_math`` on the
whole input.

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
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import _param, tp_combine


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
    # a fixed-length count (``bincount``'s length follows the data,
    # which a fake tensor mode cannot trace); exact integers either way
    counts = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(T * k, dtype=torch.float32,
                                       device=dev))
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


# ---- sharded bodies -------------------------------------------------------


def _group_mean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return shd.all_reduce(x, group.group) / group.size


# logical specs of the expert weights (the reference's ``init_moe``)
SPECS = {"router": (None, None), "w1": (None, "fsdp_expert", "tp"),
         "w3": (None, "fsdp_expert", "tp"), "w2": (None, "tp", "fsdp_expert"),
         "sw1": ("fsdp_expert", "tp"), "sw3": ("fsdp_expert", "tp"),
         "sw2": ("tp", "fsdp_expert")}


def _gather_storage(cfg: ArchConfig, p, rules) -> dict:
    """ZeRO-3: each weight's storage block gathered (``GatherParam``,
    with autograd); the F dimension, if split over the model axis,
    stays the rank's slice."""
    whole = init_moe(cfg, device="meta")
    return {k: shd.GatherParam.apply(
        w, shd.param_layout(rules, SPECS[k], whole[k].shape), rules.mesh)
        for k, w in p.items()}


def _token_body(cfg, tp, x, router, w1, w3, w2, shared):
    """Per-rank MoE over the rank's tokens.  x: (T_local, D)."""
    out, aux, zloss = _moe_math(cfg, x, router, w1, w3, w2, shared)
    if tp is not None:   # TP partials, routed + shared, summed once
        out = shd.all_reduce(out, tp.group)
    return out, aux, zloss


def _megatron_body(cfg, tp, seq, x, router, w1, w3, w2, shared):
    """Sequence-sharded residual stream: one all-gather, one
    reduce-scatter.  x: (B_local, S_local, D), S cut over ``seq``."""
    B, _, D = x.shape
    x_full = shd.all_gather(x, 1, None if seq is None else seq.group)
    S = x_full.shape[1]
    out, aux, zloss = _moe_math(cfg, x_full.reshape(B * S, D), router,
                                w1, w3, w2, shared)
    return tp_combine(out.reshape(B, S, D), tp, seq), aux, zloss


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux + zloss).  Under
    a mesh with an axis larger than 1, ``x`` and ``p`` are the rank's
    local blocks and so is the output."""
    B, S, D = x.shape
    rules = shd.active_rules()
    if rules is None or all(n == 1 for n in
                            shd.mesh_sizes(rules.mesh).values()):
        shared = tuple(p[k] for k in ("sw1", "sw3", "sw2") if k in p) or None
        out, aux, zloss = _moe_math(cfg, x.reshape(B * S, D), p["router"],
                                    p["w1"], p["w3"], p["w2"], shared)
        return out.reshape(B, S, D).to(x.dtype), aux + zloss
    own = shd.in_gathered()
    w = dict(p.items()) if own else _gather_storage(cfg, p, rules)
    shared = tuple(w[k] for k in ("sw1", "sw3", "sw2") if k in w) or None
    weights = (w["router"], w["w1"], w["w3"], w["w2"], shared)
    tp = shd.tp_group(cfg.moe.d_ff_expert, w["w1"].shape[2])
    if rules.strategy == "megatron_sp":
        out, aux, zloss = _megatron_body(
            cfg, tp, shd.logical_group(rules, "act_seq"), x, *weights)
    else:
        out, aux, zloss = _token_body(cfg, tp, x.reshape(B * S, D),
                                      *weights)
    if not own:
        fsdp = shd.logical_group(rules, "fsdp_expert")
        aux, zloss = _group_mean(aux, fsdp), _group_mean(zloss, fsdp)
    return out.reshape(B, S, D).to(x.dtype), aux + zloss
