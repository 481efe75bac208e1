"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch.

The counterpart of ``repro.models.moe``.  Tokens are sorted by expert,
packed into ``C`` slots per expert with gathers (no O(T^2) one-hot
dispatch), run through batched expert products, and combined back with
their gates.  Dispatch is shard-local: under active ``MeshRules`` whose
mesh has an axis larger than 1, ``moe_ffn`` takes the reference's
sharded paths by strategy, each rank holding its local tokens and
weight blocks (``sharding.local_shard``):

  token path (fsdp / fsdp_dp / tp_dp / tp_sp) — the rank's tokens; the
      expert weights all-gathered over the ``fsdp_expert`` axes
      (ZeRO-3); if TP is on, the expert-F partials summed once over
      ``tp`` at the end.
  megatron path (megatron_sp) — the residual stream sequence-sharded
      over ``tp``: the sequence all-gathered once, every tp rank routing
      the same tokens with its F-shard, the output reduce-scattered back
      on the sequence.

Each body computes ``C`` from the rank's own token count, as the
reference does inside its ``shard_map``, and averages ``aux`` and
``zloss`` over the fsdp group.  The collectives run through
``torch.distributed`` on ``sharding.axes_group``; they carry no
autograd, so these bodies run forward only.  Training takes the token
path under FSDP execution: there the block's weights arrive whole,
gathered at use with an autograd (``sharding.gathered``), and
``moe_ffn`` runs ``_moe_math`` on the rank's own tokens, ``C`` from
their count, returning the rank's own ``aux + zloss``, which the loss
averages over the ranks (``layers.sharded_objective``); the megatron
body and a ``tp`` group larger than 1 still raise under autograd.  When
every mesh axis has size 1, or no rules are active, ``moe_ffn`` is
``_moe_math`` on the whole input.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
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


# ---- sharded bodies -------------------------------------------------------


def _group_mean(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def _gather_weights(fsdp_group, router, w1, w3, w2, shared):
    """ZeRO-3: reassemble the expert weights' storage shards (the TP dim,
    if any, stays sharded: it is contracted and summed over tp)."""
    if fsdp_group is not None:
        w1 = shd.all_gather_dim(w1, 1, fsdp_group)
        w3 = shd.all_gather_dim(w3, 1, fsdp_group)
        w2 = shd.all_gather_dim(w2, 2, fsdp_group)
        if shared:
            sw1, sw3, sw2 = shared
            shared = (shd.all_gather_dim(sw1, 0, fsdp_group),
                      shd.all_gather_dim(sw3, 0, fsdp_group),
                      shd.all_gather_dim(sw2, 1, fsdp_group))
    return router, w1, w3, w2, shared


def _token_body(cfg, fsdp_group, tp_group, x, router, w1, w3, w2, shared):
    """Per-rank MoE over the rank's tokens.  x: (T_local, D)."""
    router, w1, w3, w2, shared = _gather_weights(fsdp_group, router, w1,
                                                 w3, w2, shared)
    out, aux, zloss = _moe_math(cfg, x, router, w1, w3, w2, shared)
    if fsdp_group is not None:
        aux, zloss = _group_mean(aux, fsdp_group), _group_mean(zloss,
                                                               fsdp_group)
    if tp_group is not None:   # TP partials, routed + shared, summed once
        dist.all_reduce(out, group=tp_group)
    return out, aux, zloss


def _megatron_body(cfg, fsdp_group, tp_group, x, router, w1, w3, w2,
                   shared):
    """Sequence-sharded residual stream: one all-gather, one
    reduce-scatter.  x: (B_local, S_local, D), S sharded over tp."""
    B, _, D = x.shape
    x_full = x if tp_group is None else shd.all_gather_dim(x, 1, tp_group)
    S = x_full.shape[1]
    router, w1, w3, w2, shared = _gather_weights(fsdp_group, router, w1,
                                                 w3, w2, shared)
    out, aux, zloss = _moe_math(cfg, x_full.reshape(B * S, D), router,
                                w1, w3, w2, shared)
    if fsdp_group is not None:
        aux, zloss = _group_mean(aux, fsdp_group), _group_mean(zloss,
                                                               fsdp_group)
    out = out.reshape(B, S, D)
    if tp_group is not None:
        n = dist.get_world_size(tp_group)
        local = torch.empty_like(x)
        dist.reduce_scatter(local, [c.contiguous()
                                    for c in out.chunk(n, dim=1)],
                            group=tp_group)
        out = local
    return out, aux, zloss


def _group(rules, axes):
    """The process group over ``axes``, or None where they span one
    rank (the reference's collectives are then the identity)."""
    if shd.axes_size(rules.mesh, axes) == 1:
        return None
    return shd.axes_group(rules.mesh, axes)


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux + zloss).  Under
    a mesh with an axis larger than 1, ``x`` and ``p`` are the rank's
    local blocks and so is the output."""
    B, S, D = x.shape
    shared = tuple(p[k] for k in ("sw1", "sw3", "sw2") if k in p) or None
    weights = (p["router"], p["w1"], p["w3"], p["w2"], shared)
    rules = shd.active_rules()
    if rules is None or all(n == 1 for n in
                            shd.mesh_sizes(rules.mesh).values()):
        out, aux, zloss = _moe_math(cfg, x.reshape(B * S, D), *weights)
        return out.reshape(B, S, D).to(x.dtype), aux + zloss
    t = rules.table
    tp_wide = shd.axes_size(rules.mesh, t["tp"]) > 1
    if shd.in_gathered() and not tp_wide:
        # FSDP execution: whole weights, the rank's tokens, its own aux
        out, aux, zloss = _moe_math(cfg, x.reshape(B * S, D), *weights)
        return out.reshape(B, S, D).to(x.dtype), aux + zloss

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights[:4], *(shared or ()))):
        raise NotImplementedError(
            "the sharded MoE bodies run forward only: their collectives "
            "carry no autograd")
    fsdp, tp = _group(rules, t["fsdp_expert"]), _group(rules, t["tp"])
    if rules.strategy == "megatron_sp":
        out, aux, zloss = _megatron_body(cfg, fsdp, tp, x, *weights)
        return out.to(x.dtype), aux + zloss
    out, aux, zloss = _token_body(cfg, fsdp, tp, x.reshape(B * S, D),
                                  *weights)
    return out.reshape(B, S, D).to(x.dtype), aux + zloss
