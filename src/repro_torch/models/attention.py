"""Attention: GQA/MHA/MQA flash-style blockwise attention, MLA, and the
decode paths.

The counterpart of ``repro.models.attention``.  Layouts are the
reference's:
  q weights  (D, H, hd)
  kv weights (D, K, hd)
  o weights  (H, hd, D)

Prefill attention is the reference's online softmax over (q-block,
kv-block) pairs (``_flash_fwd_scan``), written as two Python loops of
plain torch ops, not SDPA, so its numbers and masking are the
reference's: scores in float32 from operands upcast before the product,
masked scores ``s * mask + _NEG * (1 - mask)``, the probabilities cast
to the values' dtype before the value product, and ``acc / max(l,
1e-20)``.  Query head h reads KV head h // G (``repeat_interleave``).
Its backward is the reference's FlashAttention backward
(``_flash_core_bwd``) as a ``torch.autograd.Function``: scores
recomputed per block pair from the saved LSE, dq per query block, dk
and dv accumulated in float32 and folded from the G query heads onto
their KV head.

Decode attends one query against the cache and writes the new K and V
into it in place at ``min(pos, S - 1)`` (the reference's
``dynamic_update_slice`` clamps the same way), with keys
``arange(S) <= pos`` valid and a plain softmax.

Under the model axis (``distributed.sharding``), as the reference's
``HEAD_TP = "padded"`` lays it out: ``wq`` and ``wo`` (MLA: also ``wuk``
and ``wuv``) hold the rank's slice of the heads, ``wk`` / ``wv`` / ``wdkv``
are whole, and each rank attends with its query heads against the KV
heads they read; ``wo``'s output is then the rank's partial sum, which
the caller adds up (``layers.tp_combine``).  Where the model axis does
not divide the heads the weights are whole and the layer runs unsplit.
Decode against a cache cut on the sequence over ``sp`` (a ``sharding.
AxisGroup``: each rank holds its block of the positions) is the
reference's sharded softmax made explicit: the query heads all-gathered
over the model axis, each rank's max, sum of exponentials and weighted
values over its own positions, combined over ``sp`` (flash-decode),
the rank's ``wo`` slice applied and the output all-reduced.  Only the
rank that owns position ``min(pos, S - 1)`` writes it.

MLA (DeepSeek-V2) prefill up-projects the latent and runs the same
flash attention with K == H, q and k of nope + rope = 192 and v of 128
(scale ``192 ** -0.5``).  Its decode is the absorbed form over the
latent cache ``(B, S, r)`` + ``(B, S, rope)``, with the reference's
dtypes: ``q_lat`` a product in the compute dtype, both score products
in float32 (operands upcast, which is exact for bf16), the softmax
weights cast to the cache's dtype before the value product.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import _param, apply_rope

_NEG = -1e30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def init_attention(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return nn.ParameterDict({
        "wq": _param((d, H, hd), dt, device),
        "wk": _param((d, K, hd), dt, device),
        "wv": _param((d, K, hd), dt, device),
        "wo": _param((H, hd, d), dt, device)})


def init_mla(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = cfg.param_dtype
    return nn.ParameterDict({
        "wq": _param((d, H, qk_head), dt, device),
        "wdkv": _param((d, m.kv_lora_rank + m.qk_rope_head_dim), dt, device),
        "wuk": _param((m.kv_lora_rank, H, m.qk_nope_head_dim), dt, device),
        "wuv": _param((m.kv_lora_rank, H, m.v_head_dim), dt, device),
        "wo": _param((H, m.v_head_dim, d), dt, device)})


# --------------------------------------------------------------------------
# flash attention (train / prefill)
# --------------------------------------------------------------------------
#
# Two implementations, selected by FLASH_IMPL (the reference's switch):
#   "vjp"  — FlashAttention, a torch.autograd.Function: the forward saves
#            only (q, k, v, out, LSE); the backward replays the block
#            loops computing p = exp(s - LSE) directly and accumulates
#            dq, dk, dv — O(S) residuals, one extra attention pass.
#   "scan" — autograd through the forward's block loop, each inner step
#            under torch.utils.checkpoint (the reference checkpoints each
#            inner scan step): correct, but it keeps every step's carry.

FLASH_IMPL = "vjp"


def _blocks(q: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int):
    Sq, Sk = q.shape[1], v.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: lengths {(Sq, Sk)} are not "
                         f"multiples of the blocks {(bq, bk)}")
    return bq, bk


def _masked_out(causal: bool, q_offset: int, i: int, bq: int,
                j: int) -> bool:
    """Whether key block ``j`` is masked for every row of query block
    ``i``: its p is 0 and its correction exp(0) = 1, so the reference's
    loop leaves m, l and acc bit-identical past it, and its dq, dk and
    dv terms are zeros."""
    return causal and j > q_offset + i + bq - 1


def _scores(q_i: torch.Tensor, k_j: torch.Tensor, causal: bool,
            qp: torch.Tensor, j: int, scale: float):
    """Scaled float32 scores (B, H, bq, bk) of one block pair, masked as
    the reference masks them, and the mask (None when not causal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j.float()) * scale
    if not causal:
        return s, None
    kp = torch.arange(j, j + k_j.shape[1], device=s.device)
    mask = (qp[:, None] >= kp[None, :]).float()
    return s * mask + _NEG * (1.0 - mask), mask


def _fwd_step(q_i, k_j, v_j, m, l, acc, qp, j: int, causal: bool,
              scale: float, G: int):
    """One online-softmax step: (m, l, acc) after key block ``j``."""
    k_j = k_j.repeat_interleave(G, dim=2)
    v_rep = v_j.repeat_interleave(G, dim=2)
    s, mask = _scores(q_i, k_j, causal, qp, j, scale)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = p * mask                             # zero masked entries
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_j.dtype).float(),
                      v_rep.float())
    return m_new, l, acc * corr[..., None] + pv


def _flash_fwd(q, k, v, causal: bool, q_offset: int, bq: int, bk: int,
               checkpoint_inner: bool = False):
    """The block loop: (out (B, Sq, H, hdv) in q's dtype, LSE (B, H, Sq)
    float32).  ``checkpoint_inner`` runs each step under
    ``torch.utils.checkpoint`` (the "scan" route's backward)."""
    B, Sq, H, hd = q.shape
    _, Sk, K, hdv = v.shape
    G = H // K
    scale = hd ** -0.5
    dev = q.device
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    for i in range(0, Sq, bq):
        q_i = q[:, i:i + bq].float()
        qp = q_offset + torch.arange(i, i + bq, device=dev)
        m = torch.full((B, H, bq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, hdv), dtype=torch.float32, device=dev)
        for j in range(0, Sk, bk):
            if _masked_out(causal, q_offset, i, bq, j):
                break
            args = (q_i, k[:, j:j + bk], v[:, j:j + bk], m, l, acc, qp, j,
                    causal, scale, G)
            if checkpoint_inner:
                m, l, acc = checkpoint(_fwd_step, *args, use_reentrant=False)
            else:
                m, l, acc = _fwd_step(*args)
        l = torch.clamp_min(l, 1e-20)
        out[:, i:i + bq] = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
        lse[:, :, i:i + bq] = m + torch.log(l)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """``_flash_core_fwd`` / ``_flash_core_bwd`` of the reference."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, bq, bk):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, bq, bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, bq, bk)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, bq, bk = ctx.args
        B, Sq, H, hd = q.shape
        _, Sk, K, hdv = v.shape
        G = H // K
        scale = hd ** -0.5
        dev = q.device
        # D_i = rowsum(dout * out) in float32, the softmax-grad diagonal
        D = torch.einsum("bshd,bshd->bhs", dout.float(), out.float())
        dq = torch.empty_like(q)
        dk = torch.zeros((B, Sk, K, hd), dtype=torch.float32, device=dev)
        dv = torch.zeros((B, Sk, K, hdv), dtype=torch.float32, device=dev)
        for i in range(0, Sq, bq):
            q_i = q[:, i:i + bq].float()
            do_i = dout[:, i:i + bq].float()
            L_i = lse[:, :, i:i + bq, None]
            D_i = D[:, :, i:i + bq, None]
            qp = q_offset + torch.arange(i, i + bq, device=dev)
            dq_i = torch.zeros((B, bq, H, hd), dtype=torch.float32,
                               device=dev)
            for j in range(0, Sk, bk):
                if _masked_out(causal, q_offset, i, bq, j):
                    break
                k_rep = k[:, j:j + bk].repeat_interleave(G, dim=2).float()
                v_rep = v[:, j:j + bk].repeat_interleave(G, dim=2).float()
                s, mask = _scores(q_i, k_rep, causal, qp, j, scale)
                p = torch.exp(s - L_i)                  # (B, H, bq, bk)
                if causal:
                    p = p * mask
                dp = torch.einsum("bqhd,bkhd->bhqk", do_i, v_rep)
                ds = p * (dp - D_i) * scale
                dq_i = dq_i + torch.einsum("bhqk,bkhd->bqhd", ds, k_rep)
                # fold the G query heads of a group onto their KV head
                dk_j = torch.einsum("bhqk,bqhd->bkhd", ds, q_i)
                dv_j = torch.einsum("bhqk,bqhd->bkhd", p, do_i)
                dk[:, j:j + bk] += dk_j.reshape(B, -1, K, G, hd).sum(3)
                dv[:, j:j + bk] += dv_j.reshape(B, -1, K, G, hdv).sum(3)
            dq[:, i:i + bq] = dq_i.to(q.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hdv)
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (prefill cont.)
    block_q: int = 512,
    block_k: int = 512,
    impl: str | None = None,
) -> torch.Tensor:
    bq, bk = _blocks(q, v, block_q, block_k)
    impl = impl or FLASH_IMPL
    if impl == "vjp":
        return _FlashAttention.apply(q, k, v, causal, q_offset, bq, bk)
    if impl != "scan":
        raise ValueError(f"flash_attention: unknown impl {impl!r}")
    return _flash_fwd(q, k, v, causal, q_offset, bq, bk,
                      checkpoint_inner=torch.is_grad_enabled())[0]


# --------------------------------------------------------------------------
# GQA layer application
# --------------------------------------------------------------------------


def _qkv(cfg: ArchConfig, p, x: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _local_kv(k: torch.Tensor, v: torch.Tensor, head0: int, n: int,
              G: int):
    """The KV heads that query heads ``head0 .. head0 + n - 1`` read (head
    h reads KV head h // G), so that flash's group size ``n // K_local``
    pairs each local query head with its own."""
    if n == k.shape[2] * G:
        return k, v
    lo = head0 // G
    if n % G == 0 and head0 % G == 0:
        return k[:, :, lo:lo + n // G], v[:, :, lo:lo + n // G]
    if G % n == 0 and head0 % n == 0:          # every local head reads one
        return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1]
    idx = torch.arange(head0, head0 + n, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_forward(cfg: ArchConfig, p, x: torch.Tensor,
                positions: torch.Tensor, *, q_offset: int = 0,
                kv_out: bool = False):
    """Prefill attention.  Returns (out, (k, v)) — k/v (every KV head)
    for the cache; with ``wq`` / ``wo`` the rank's head slice, ``out``
    is its partial sum."""
    q, k, v = _qkv(cfg, p, x, positions)
    n = q.shape[2]
    tp = shd.tp_group(cfg.n_heads, n)
    k_h, v_h = _local_kv(k, v, 0 if tp is None else tp.index * n, n,
                         cfg.n_heads // cfg.n_kv_heads)
    o = flash_attention(q, k_h, v_h, causal=True, q_offset=q_offset)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, ((k, v) if kv_out else None)


def _decode_qkv(cfg: ArchConfig, p, x: torch.Tensor, pos):
    """``pos`` as a 0-d int32 tensor, and q, k, v of one token there."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, pos.expand(B, 1))
    return pos, q, k, v


def _write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
           sp=None) -> None:
    """``cache[:, min(pos, S - 1)] = new`` in place (cache: (B, S, ...),
    new: (B, 1, ...)).  With ``sp`` the cache is the rank's block of a
    sequence ``sp.size`` times as long, and only the rank that owns the
    position writes (the others write back what they hold)."""
    S = cache.shape[1]
    if sp is None:
        idx = torch.clamp_max(pos, S - 1).reshape(1).long()
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    at = torch.clamp_max(pos, S * sp.size - 1) - sp.index * S
    idx = at.clamp(0, S - 1).reshape(1).long()
    mine = (at >= 0) & (at < S)
    cache.index_copy_(1, idx, torch.where(mine, new.to(cache.dtype),
                                          cache.index_select(1, idx)))


def _valid(S: int, pos: torch.Tensor, sp, device) -> torch.Tensor:
    """Which of the cache block's S positions are ``<= pos``."""
    first = 0 if sp is None else sp.index * S
    return torch.arange(first, first + S, device=device) <= pos


def _attend(s: torch.Tensor, vals: torch.Tensor, spec: str, sp,
            v_scale: torch.Tensor | None = None):
    """``softmax(s) @ vals`` in ``vals``' dtype, the softmax over the
    last axis of ``s`` (float32, masked) and ``spec`` the value product.
    With ``v_scale`` (int8 ``vals``: each position's scale, shaped as
    ``s``) each weight is multiplied by its position's scale and the
    product runs on the values in float32, which it returns.  With
    ``sp`` the positions are the rank's block: its max, sum of
    exponentials and weighted values are combined over the group."""
    if sp is None:
        w = torch.softmax(s, dim=-1)
        if v_scale is not None:
            return torch.einsum(spec, w * v_scale, vals.float())
        return torch.einsum(spec, w.to(vals.dtype), vals)
    top = shd.all_reduce_(s.amax(-1), sp.group, shd.reduce_op("max"))
    e = torch.exp(s - top[..., None])
    ew = e.to(vals.dtype).float() if v_scale is None else e * v_scale
    o = torch.einsum(spec, ew, vals.float())
    both = shd.all_reduce_(torch.cat([o, e.sum(-1)[..., None]], -1),
                           sp.group)
    o = both[..., :-1] / both[..., -1:]
    return o if v_scale is not None else o.to(vals.dtype)


def _heads_out(o: torch.Tensor, wo: torch.Tensor, tp) -> torch.Tensor:
    """(B, H, hd) values of every head -> (B, 1, D) through the rank's
    ``wo`` head slice, summed over the model axis."""
    if tp is not None:
        n = wo.shape[0]
        o = o[:, tp.index * n:(tp.index + 1) * n]
    out = torch.einsum("bhk,hkd->bd", o, wo)[:, None, :]
    return out if tp is None else shd.all_reduce_(out, tp.group)


def gqa_decode(cfg: ArchConfig, p, x: torch.Tensor, pos,
               k_cache: torch.Tensor, v_cache: torch.Tensor, sp=None):
    """Single-token decode.  x: (B, 1, D); pos: 0-d int32, the position
    being written; caches: (B, S_max, K, hd), updated in place (with
    ``sp``, the rank's block of the positions).  Returns (out, k_cache,
    v_cache)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    B, S = k_cache.shape[0], k_cache.shape[1]
    pos, q, k, v = _decode_qkv(cfg, p, x, pos)
    _write(k_cache, k, pos, sp)
    _write(v_cache, v, pos, sp)
    tp = shd.tp_group(H, q.shape[2])
    if tp is not None:                 # every head reads the rank's block
        q = shd.all_gather_dim(q, 2, tp.group)

    qg = q.reshape(B, K, G, hd)        # query head h reads kv head h // G
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * (hd ** -0.5)
    s = torch.where(_valid(S, pos, sp, x.device), s, _NEG)
    o = _attend(s, v_cache, "bkgs,bskd->bkgd", sp)
    out = _heads_out(o.reshape(B, H, hd), p["wo"], tp)
    return out.to(x.dtype), k_cache, v_cache


def quantize_kv(x: torch.Tensor):
    """Per-(token, kv-head) symmetric int8 over head_dim.
    x: (..., hd) -> (int8 values, f32 scale without the hd dim)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def gqa_decode_q8(cfg: ArchConfig, p, x: torch.Tensor, pos,
                  k_cache, v_cache, k_scale, v_scale, sp=None):
    """gqa_decode against an int8-quantized cache: (B, S, K, hd) int8 +
    (B, S, K) f32 scales, all updated in place (with ``sp``, the rank's
    block of the positions: the owner writes all four).  ``k_scale`` is
    folded into the scores and ``v_scale`` into the weights before the
    value product, so a sequence-sharded softmax combines the
    reference's ``w * v_scale``; with ``wq`` / ``wo`` the rank's head
    slice, every head reads the rank's block and the output is summed
    over the model axis, as in :func:`gqa_decode`."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    B, S = k_cache.shape[0], k_cache.shape[1]
    pos, q, k, v = _decode_qkv(cfg, p, x, pos)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    _write(k_cache, kq, pos, sp)
    _write(v_cache, vq, pos, sp)
    _write(k_scale, ks, pos, sp)
    _write(v_scale, vs, pos, sp)
    tp = shd.tp_group(H, q.shape[2])
    if tp is not None:                 # every head reads the rank's block
        q = shd.all_gather_dim(q, 2, tp.group)

    qg = q.reshape(B, K, G, hd)
    # dequant folded into the contraction: s = (q . k_int8) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * (hd ** -0.5)
    s = s * k_scale.transpose(1, 2)[:, :, None, :]
    s = torch.where(_valid(S, pos, sp, x.device), s, _NEG)
    o = _attend(s, v_cache, "bkgs,bskd->bkgd", sp,
                v_scale=v_scale.transpose(1, 2)[:, :, None, :])
    out = _heads_out(o.reshape(B, H, hd).to(x.dtype), p["wo"], tp)
    return out.to(x.dtype), k_cache, v_cache, k_scale, v_scale


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-latent KV cache
# --------------------------------------------------------------------------


def _mla_project(cfg: ArchConfig, p, x: torch.Tensor,
                 positions: torch.Tensor):
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    dkv = x @ p["wdkv"]                              # (B, S, r + rope)
    c_kv = dkv[..., :m.kv_lora_rank]
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)              # (B, S, 1, rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(cfg: ArchConfig, p, x: torch.Tensor,
                positions: torch.Tensor, *, kv_out: bool = False):
    """Prefill MLA: up-project the latent and run flash with K == H (the
    rank's heads, when ``wq`` holds a slice of them: ``out`` is then its
    partial sum).  Returns (out, (c_kv (B, S, r), k_rope (B, S, rope)))
    for the cache."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wuk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wuv"])
    k_rope_rep = k_rope.expand(-1, -1, q_nope.shape[2], -1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope_rep], dim=-1)
    o = flash_attention(q_cat, k_cat, v, causal=True)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, ((c_kv, k_rope[:, :, 0, :]) if kv_out else None)


def mla_decode(cfg: ArchConfig, p, x: torch.Tensor, pos,
               ckv_cache: torch.Tensor, krope_cache: torch.Tensor, sp=None):
    """Absorbed-weight MLA decode: scores and values in latent space.
    x: (B, 1, D); pos: 0-d int32; caches (B, S, r) and (B, S, rope),
    updated in place (with ``sp``, the rank's block of the positions).
    Returns (out, ckv_cache, krope_cache)."""
    m = cfg.mla
    B, S = x.shape[0], ckv_cache.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, p, x, pos.expand(B, 1))
    _write(ckv_cache, c_kv, pos, sp)
    _write(krope_cache, k_rope[:, :, 0, :], pos, sp)

    # absorb W_uk into q: (B, 1, H, dn) . (r, H, dn) -> (B, H, r)
    q_lat = torch.einsum("bshk,rhk->bhr", q_nope, p["wuk"])
    q_rope = q_rope[:, 0]
    tp = shd.tp_group(cfg.n_heads, q_lat.shape[1])
    if tp is not None:                 # every head reads the rank's block
        q_lat = shd.all_gather_dim(q_lat, 1, tp.group)
        q_rope = shd.all_gather_dim(q_rope, 1, tp.group)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_cache.float())
         + torch.einsum("bhp,bsp->bhs", q_rope.float(),
                        krope_cache.float())) * scale
    s = torch.where(_valid(S, pos, sp, x.device), s, _NEG)
    o_lat = _attend(s, ckv_cache, "bhs,bsr->bhr", sp)
    if tp is not None:
        n = p["wuv"].shape[1]
        o_lat = o_lat[:, tp.index * n:(tp.index + 1) * n]
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["wuv"])
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
    if tp is not None:
        out = shd.all_reduce_(out, tp.group)
    return out.to(x.dtype), ckv_cache, krope_cache
