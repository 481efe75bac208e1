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
reference's: scores a mixed product (``layers.mixed_einsum``: the
operands in their dtype, a float32 result), masked scores ``s * mask +
_NEG * (1 - mask)``, the probabilities cast to the values' dtype before
the mixed value product, and ``acc / max(l, 1e-20)``.  Query head h
reads KV head h // G (``repeat_interleave``).
Its backward is the reference's FlashAttention backward
(``_flash_core_bwd``) as a ``torch.autograd.Function``: scores
recomputed per block pair (a mixed product) from the saved LSE, its
other four products in float32 as the reference's, dq per query block,
dk and dv accumulated in float32 and folded from the G query heads onto
their KV head.
Inference in bf16 on the card with head widths of 128 and the heads
whole (``_kernel_route``: no gradient wanted, as under the serve
engine's ``inference_mode``) goes instead to one launch of the
hand-written kernel ``kernels.flash_fwd``, which computes the loop's
function in its arithmetic with S and P kept in registers.  Each call
adds 1 to the recorder's ``attn.flash`` counter, and the kernel's route
also to ``attn.flash_kernel``.

Decode attends one query against the cache and writes the new K and V
into it in place at ``min(pos, S - 1)`` (the reference's
``dynamic_update_slice`` clamps the same way), with keys
``arange(S) <= pos`` valid and a plain softmax.

Under the model axis (``distributed.sharding``) a GQA layer is laid out
as the reference's ``HEAD_TP`` says when the model is built
(``attention_specs``).  ``"padded"``: ``wq`` and ``wo`` (MLA, whatever
``HEAD_TP``: also ``wuk`` and ``wuv``) hold the rank's slice of the
heads, ``wk`` / ``wv`` / ``wdkv`` are whole, and each rank attends with
its query heads against the KV heads they read; where the model axis
does not divide the heads the weights are whole and the layer runs
unsplit.  ``"head_dim"`` (where ``n_heads % 16 != 0``, the reference's
rule): ``wq``, ``wk``, ``wv`` and ``wo`` hold the rank's slice of the
head dimension, the contraction.  q and k are all-gathered for the
rotate-half RoPE (dimension i pairs with i + hd/2, which another rank
holds) and cut back; each block pair's scores are the rank's partial
sum, all-reduced before the online softmax (the reference's
"psum-per-block"), and in the backward the recomputed scores, ``dp`` and
``D`` likewise; the values and dq, dk, dv are the rank's slices.  Either
way ``wo``'s output is the rank's partial sum, which the caller adds up
(``layers.tp_combine``).
Decode against a cache cut on the sequence over ``sp`` (a ``sharding.
AxisGroup``: each rank holds its block of the positions) is the
reference's sharded softmax made explicit: the query heads all-gathered
over the model axis (under ``"head_dim"``: q, k and v all-gathered on
the head dimension after the projection, so RoPE, quantization and the
cache write see whole vectors), each rank's max, sum of exponentials
and weighted values over its own positions, combined over ``sp``
(flash-decode), the rank's ``wo`` slice applied and the output
all-reduced.  Only the rank that owns position ``min(pos, S - 1)``
writes it.

MLA (DeepSeek-V2) prefill up-projects the latent and runs the same
flash attention with K == H, q and k of nope + rope = 192 and v of 128
(scale ``192 ** -0.5``).  Its decode is the absorbed form over the
latent cache ``(B, S, r)`` + ``(B, S, rope)``, with the reference's
dtypes: ``q_lat`` a product in the compute dtype, both score products
mixed (a float32 result), the softmax weights cast to the cache's dtype
before the value product.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_fwd as _ff
from repro_torch.models.layers import _param, apply_rope, mixed_einsum

_NEG = -1e30
FLASH_BLOCK = 512              # the loop's query and key blocks, by default

# the GQA layers' layout over the model axis, read when a model is built
# (the reference's switch): "padded" (heads) or "head_dim"
HEAD_TP = "padded"


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


def attention_specs(cfg: ArchConfig) -> dict:
    """The logical specs of a GQA layer's weights, keyed (``"attn"``,
    leaf), as the reference's ``init_attention`` returns them under
    ``HEAD_TP``: the heads on ``tp`` where ``n_heads % 16 == 0`` or
    ``HEAD_TP`` is ``"padded"``, else the head dimension.  MLA's are
    not this switch's (``init_mla`` does not read it): empty."""
    if cfg.attention == "mla":
        return {}
    if HEAD_TP not in ("padded", "head_dim"):
        raise ValueError(f"HEAD_TP {HEAD_TP!r} is not 'padded' or "
                         "'head_dim'")
    if cfg.n_heads % 16 == 0 or HEAD_TP == "padded":
        specs = {"wq": ("fsdp", "tp", None), "wk": ("fsdp", None, None),
                 "wv": ("fsdp", None, None), "wo": ("tp", None, "fsdp")}
    else:
        specs = {"wq": ("fsdp", None, "tp"), "wk": ("fsdp", None, "tp"),
                 "wv": ("fsdp", None, "tp"), "wo": (None, "tp", "fsdp")}
    return {("attn", k): v for k, v in specs.items()}


def head_split(cfg: ArchConfig, p):
    """(the model axis's ``AxisGroup``, the dimension of q / k / v it
    splits: 2 the heads, 3 the head dimension) of a layer whose weights
    ``p`` hold the rank's slice, read from ``wq``'s shape; (None, None)
    where they are whole and the layer runs unsplit."""
    wq = p["wq"]
    if wq.shape[1] != cfg.n_heads:
        return shd.tp_group(cfg.n_heads, wq.shape[1]), 2
    if "wk" in p and wq.shape[2] != cfg.head_dim:
        return shd.tp_group(cfg.head_dim, wq.shape[2]), 3
    return None, None


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


def _sum_over(x: torch.Tensor, tp) -> torch.Tensor:
    """``x``, a partial sum over the rank's slice of the head dimension,
    summed over ``tp`` (None: ``x``); with autograd where it is on."""
    if tp is None:
        return x
    if torch.is_grad_enabled():
        return shd.all_reduce(x, tp.group)
    return shd.all_reduce_(x.contiguous(), tp.group)


def _mask(s: torch.Tensor, causal: bool, qp: torch.Tensor, j: int):
    """Scores masked as the reference masks them, and the mask (None
    when not causal)."""
    if not causal:
        return s, None
    kp = torch.arange(j, j + s.shape[-1], device=s.device)
    mask = (qp[:, None] >= kp[None, :]).float()
    return s * mask + _NEG * (1.0 - mask), mask


def _scores(q_i: torch.Tensor, k_j: torch.Tensor, causal: bool,
            qp: torch.Tensor, j: int, scale: float, tp=None):
    """Scaled float32 scores (B, H, bq, bk) of one block pair, a mixed
    product (summed over ``tp`` where q and k are the rank's slice of
    the head dimension), masked, and the mask (None when not causal)."""
    s = _sum_over(mixed_einsum("bqhd,bkhd->bhqk", q_i, k_j), tp) * scale
    return _mask(s, causal, qp, j)


def _fwd_step(q_i, k_j, v_j, m, l, acc, qp, j: int, causal: bool,
              scale: float, G: int, tp=None):
    """One online-softmax step: (m, l, acc) after key block ``j``."""
    k_j = k_j.repeat_interleave(G, dim=2)
    v_rep = v_j.repeat_interleave(G, dim=2)
    s, mask = _scores(q_i, k_j, causal, qp, j, scale, tp)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = p * mask                             # zero masked entries
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    pv = mixed_einsum("bhqk,bkhd->bhqd", p.to(v_j.dtype), v_rep)
    return m_new, l, acc * corr[..., None] + pv


def _scale(q: torch.Tensor, tp) -> float:
    """The scores' ``hd ** -0.5`` of the whole head dimension (``q``'s,
    times ``tp``'s ranks where it is the rank's slice)."""
    return (q.shape[-1] * (1 if tp is None else tp.size)) ** -0.5


def _flash_fwd(q, k, v, causal: bool, q_offset: int, bq: int, bk: int,
               checkpoint_inner: bool = False, tp=None):
    """The block loop: (out (B, Sq, H, hdv) in q's dtype, LSE (B, H, Sq)
    float32).  ``checkpoint_inner`` runs each step under
    ``torch.utils.checkpoint`` (the "scan" route's backward).  ``tp``:
    q, k and v are the rank's slices of the head dimension (the scores
    summed over it per block pair; ``out`` the rank's slice)."""
    B, Sq, H, hd = q.shape
    _, Sk, K, hdv = v.shape
    G = H // K
    scale = _scale(q, tp)
    dev = q.device
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    for i in range(0, Sq, bq):
        q_i = q[:, i:i + bq]
        qp = q_offset + torch.arange(i, i + bq, device=dev)
        m = torch.full((B, H, bq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, hdv), dtype=torch.float32, device=dev)
        for j in range(0, Sk, bk):
            if _masked_out(causal, q_offset, i, bq, j):
                break
            args = (q_i, k[:, j:j + bk], v[:, j:j + bk], m, l, acc, qp, j,
                    causal, scale, G, tp)
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
    def forward(ctx, q, k, v, causal, q_offset, bq, bk, tp):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, bq, bk, tp=tp)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, bq, bk, tp)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, bq, bk, tp = ctx.args
        B, Sq, H, hd = q.shape
        _, Sk, K, hdv = v.shape
        G = H // K
        scale = _scale(q, tp)
        dev = q.device
        # D_i = rowsum(dout * out) in float32, the softmax-grad diagonal
        # (with ``tp``: summed over the head dimension's slices, as the
        # recomputed scores and dp below are)
        D = _sum_over(torch.einsum("bshd,bshd->bhs", dout.float(),
                                   out.float()), tp)
        dq = torch.empty_like(q)
        dk = torch.zeros((B, Sk, K, hd), dtype=torch.float32, device=dev)
        dv = torch.zeros((B, Sk, K, hdv), dtype=torch.float32, device=dev)
        for i in range(0, Sq, bq):
            q_b = q[:, i:i + bq]
            q_i = q_b.float()
            do_i = dout[:, i:i + bq].float()
            L_i = lse[:, :, i:i + bq, None]
            D_i = D[:, :, i:i + bq, None]
            qp = q_offset + torch.arange(i, i + bq, device=dev)
            dq_i = torch.zeros((B, bq, H, hd), dtype=torch.float32,
                               device=dev)
            for j in range(0, Sk, bk):
                if _masked_out(causal, q_offset, i, bq, j):
                    break
                k_b = k[:, j:j + bk].repeat_interleave(G, dim=2)
                k_rep = k_b.float()
                v_rep = v[:, j:j + bk].repeat_interleave(G, dim=2).float()
                s = mixed_einsum("bqhd,bkhd->bhqk", q_b, k_b)
                dp = torch.einsum("bqhd,bkhd->bhqk", do_i, v_rep)
                if tp is not None:     # one all-reduce of both partials
                    s, dp = _sum_over(torch.stack([s, dp]), tp).unbind()
                s, mask = _mask(s * scale, causal, qp, j)
                p = torch.exp(s - L_i)                  # (B, H, bq, bk)
                if causal:
                    p = p * mask
                ds = p * (dp - D_i) * scale
                dq_i = dq_i + torch.einsum("bhqk,bkhd->bqhd", ds, k_rep)
                # fold the G query heads of a group onto their KV head
                dk_j = torch.einsum("bhqk,bqhd->bkhd", ds, q_i)
                dv_j = torch.einsum("bhqk,bqhd->bkhd", p, do_i)
                dk[:, j:j + bk] += dk_j.reshape(B, -1, K, G, hd).sum(3)
                dv[:, j:j + bk] += dv_j.reshape(B, -1, K, G, hdv).sum(3)
            dq[:, i:i + bq] = dq_i.to(q.dtype)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def _kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int, tp) -> bool:
    """Whether a call goes to the inference kernel (``kernels.flash_fwd``):
    CUDA tensors, bf16 q, k and v with head widths of 128, no gradient
    wanted (the kernel keeps no LSE and has no backward: the serve
    engine's ``inference_mode`` and the dry run's ``no_grad``), the heads
    whole (``tp`` None) and ``q_offset`` >= 0.  Every other call keeps
    the block loop."""
    return (q.is_cuda and tp is None and not torch.is_grad_enabled()
            and q_offset >= 0
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] == k.shape[-1] == v.shape[-1] == _ff.HEAD_DIM)


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hdv)
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (prefill cont.)
    block_q: int = FLASH_BLOCK,
    block_k: int = FLASH_BLOCK,
    impl: str | None = None,
    tp=None,                  # q, k, v the rank's head-dimension slices
) -> torch.Tensor:
    """Attention of q over k and v, (B, Sq, H, hdv) in q's dtype.  Where
    :func:`_kernel_route` holds (inference in bf16 on the card, head
    widths of 128, the heads whole) one ``kernels.flash_fwd`` launch;
    otherwise the block loop and its backward, ``impl`` as the reference
    selects them."""
    bq, bk = _blocks(q, v, block_q, block_k)
    impl = impl or FLASH_IMPL
    if impl not in ("vjp", "scan"):
        raise ValueError(f"flash_attention: unknown impl {impl!r}")
    obs.count("attn.flash", 1)
    if _kernel_route(q, k, v, q_offset, tp):
        obs.count("attn.flash_kernel", 1)
        return _ff.flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "vjp":
        return _FlashAttention.apply(q, k, v, causal, q_offset, bq, bk, tp)
    return _flash_fwd(q, k, v, causal, q_offset, bq, bk,
                      checkpoint_inner=torch.is_grad_enabled(), tp=tp)[0]


# --------------------------------------------------------------------------
# GQA layer application
# --------------------------------------------------------------------------


def _qkv(cfg: ArchConfig, p, x: torch.Tensor, positions: torch.Tensor,
         hd_group=None):
    """q and k roped, and v.  ``hd_group``: the weights hold the rank's
    slice of the head dimension, and q, k and v are all-gathered on it
    (no autograd: decode) before RoPE, whole."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if hd_group is not None:
        q, k, v = (shd.all_gather_dim(t, 3, hd_group) for t in (q, k, v))
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
    """Prefill attention.  Returns (out, (k, v)) — k/v (every KV head,
    the whole head dimension) for the cache; with the weights the rank's
    slice of the heads or of the head dimension, ``out`` is its partial
    sum."""
    tp, dim = head_split(cfg, p)
    if dim == 3:
        return _gqa_forward_hd(cfg, p, x, positions, tp, q_offset, kv_out)
    q, k, v = _qkv(cfg, p, x, positions)
    n = q.shape[2]
    k_h, v_h = _local_kv(k, v, 0 if tp is None else tp.index * n, n,
                         cfg.n_heads // cfg.n_kv_heads)
    o = flash_attention(q, k_h, v_h, causal=True, q_offset=q_offset)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, ((k, v) if kv_out else None)


def _gqa_forward_hd(cfg: ArchConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, tp, q_offset: int,
                    kv_out: bool):
    """:func:`gqa_forward` with the weights the rank's slice of the head
    dimension (``HEAD_TP = "head_dim"``): q and k all-gathered for RoPE
    (autograd: the backward reduce-scatters), cut back to the rank's
    slice; flash sums each block pair's scores over ``tp``; ``out`` is
    the rank's partial sum through its rows of ``wo``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    n = q.shape[3]
    mine = slice(tp.index * n, (tp.index + 1) * n)
    q = apply_rope(shd.all_gather(q, 3, tp.group), positions, cfg.rope_theta)
    k = apply_rope(shd.all_gather(k, 3, tp.group), positions, cfg.rope_theta)
    o = flash_attention(q[..., mine], k[..., mine], v, causal=True,
                        q_offset=q_offset, tp=tp)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if not kv_out:
        return out, None
    return out, (k, shd.all_gather(v, 3, tp.group))


def _decode_qkv(cfg: ArchConfig, p, x: torch.Tensor, pos):
    """``pos`` as a 0-d int32 tensor, the layer's ``head_split``, and
    q, k, v of one token there (whole on the head dimension)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    tp, dim = head_split(cfg, p)
    q, k, v = _qkv(cfg, p, x, pos.expand(B, 1),
                   hd_group=tp.group if dim == 3 else None)
    return pos, (tp, dim), q, k, v


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
    if v_scale is None:
        o = mixed_einsum(spec, e.to(vals.dtype), vals)
    else:
        o = torch.einsum(spec, e * v_scale, vals.float())
    both = shd.all_reduce_(torch.cat([o, e.sum(-1)[..., None]], -1),
                           sp.group)
    o = both[..., :-1] / both[..., -1:]
    return o if v_scale is not None else o.to(vals.dtype)


def _heads_out(o: torch.Tensor, wo: torch.Tensor, split) -> torch.Tensor:
    """(B, H, hd) values of every head -> (B, 1, D) through ``wo``; with
    ``split`` (``head_split``'s) the rank's slice of the heads or of the
    head dimension, summed over the model axis."""
    tp, dim = split
    if tp is not None:
        n = wo.shape[dim - 2]
        o = o.narrow(dim - 1, tp.index * n, n)
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
    pos, split, q, k, v = _decode_qkv(cfg, p, x, pos)
    _write(k_cache, k, pos, sp)
    _write(v_cache, v, pos, sp)
    if split[1] == 2:                  # every head reads the rank's block
        q = shd.all_gather_dim(q, 2, split[0].group)

    qg = q.reshape(B, K, G, hd)        # query head h reads kv head h // G
    s = mixed_einsum("bkgd,bskd->bkgs", qg, k_cache) * (hd ** -0.5)
    s = torch.where(_valid(S, pos, sp, x.device), s, _NEG)
    o = _attend(s, v_cache, "bkgs,bskd->bkgd", sp)
    out = _heads_out(o.reshape(B, H, hd), p["wo"], split)
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
    pos, split, q, k, v = _decode_qkv(cfg, p, x, pos)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    _write(k_cache, kq, pos, sp)
    _write(v_cache, vq, pos, sp)
    _write(k_scale, ks, pos, sp)
    _write(v_scale, vs, pos, sp)
    if split[1] == 2:                  # every head reads the rank's block
        q = shd.all_gather_dim(q, 2, split[0].group)

    qg = q.reshape(B, K, G, hd)
    # dequant folded into the contraction: s = (q . k_int8) * scale, a
    # mixed product of q and the int8 values in q's dtype (exact: |k| <=
    # 127), as the reference's float32 product of the two upcast
    s = mixed_einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(qg.dtype)) * (hd ** -0.5)
    s = s * k_scale.transpose(1, 2)[:, :, None, :]
    s = torch.where(_valid(S, pos, sp, x.device), s, _NEG)
    o = _attend(s, v_cache, "bkgs,bskd->bkgd", sp,
                v_scale=v_scale.transpose(1, 2)[:, :, None, :])
    out = _heads_out(o.reshape(B, H, hd).to(x.dtype), p["wo"], split)
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
    s = (mixed_einsum("bhr,bsr->bhs", q_lat, ckv_cache)
         + mixed_einsum("bhp,bsp->bhs", q_rope, krope_cache)) * scale
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
