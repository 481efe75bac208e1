"""Shared neural-net building blocks.

The counterpart of ``repro.models.layers``.  Parameters live in
``nn.ParameterDict``s whose keys are those of the reference's params
tree (``{"scale", "bias"}``, ``{"w1", "w3", "w2"}``, ``{"tok",
"head"}``), and the ``apply_*`` functions take such a mapping and
tensors.  The ``init_*`` functions allocate the parameters
uninitialised on ``device``; the model's ``init`` fills them
(``dense_init_``).  Head-carrying weights keep the reference's
(D, H, head_dim) form and are consumed with einsum.

Numerics follow the reference: norms and rope compute in float32 and
cast back, layernorm's variance has ddof 0, gelu is the tanh
approximation (``jax.nn.gelu``'s default).  The reference's products
with ``preferred_element_type=jnp.float32`` (bf16 operands, a float32
result) are :func:`mixed_einsum`; the loss's head product is one of them
under ``XENT_MM = "mixed"`` (the reference's default), float32 from
operands upcast before the product under ``"cast"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

# the loss's head product, the reference's switch: "mixed" (its default:
# bf16 operands, a float32 result) or "cast" (both operands upcast)
XENT_MM = "mixed"

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def dense_init_(w: torch.Tensor, d_in: int,
                generator: torch.Generator) -> None:
    """Fill ``w`` with normal * d_in^-0.5 drawn in float32, then cast."""
    z = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                    device=w.device)
    w.copy_(z.mul_(d_in ** -0.5))


# --------------------------------------------------------------------------
# the mixed product: bf16 operands, a float32 result
# --------------------------------------------------------------------------

class _MixedBmm(torch.autograd.Function):
    """``bmm`` of 16-bit operands into a float32 result (``aten::bmm.
    dtype``): the operands stay in their dtype, the result is never
    rounded.  The backward is the reference's gradient of a
    ``preferred_element_type=float32`` product (``jax.grad``'s jaxpr):
    the float32 cotangent times the other operand upcast, a float32
    product cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        return mixed_bmm_grads(*ctx.saved_tensors, g, ctx.needs_input_grad)


def mixed_bmm_grads(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                    needs=(True, True)):
    """The gradients of ``a`` and ``b`` of a mixed ``bmm`` with float32
    cotangent ``g``, in ``a``'s and ``b``'s dtypes (None where not
    ``needs``)."""
    ga = gb = None
    if needs[0]:
        ga = torch.bmm(g, b.transpose(1, 2).float()).to(a.dtype)
    if needs[1]:
        gb = torch.bmm(a.transpose(1, 2).float(), g).to(b.dtype)
    return ga, gb


def _bmm_plan(spec: str):
    """An einsum of two operands as one batched product: (a's
    subscripts, b's, the output's, its batch, a-only, b-only and
    contracted subscripts).  Every subscript must be in the output or
    in both operands."""
    ins, out = spec.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    batch = [c for c in out if c in sa and c in sb]
    m = [c for c in out if c in sa and c not in sb]
    n = [c for c in out if c in sb and c not in sa]
    k = [c for c in sa if c in sb and c not in out]
    if sorted(sa) != sorted(batch + m + k) or \
            sorted(sb) != sorted(batch + k + n) or \
            len(out) != len(batch + m + n):
        raise ValueError(f"mixed_einsum: {spec!r} is not one batched "
                         "product")
    return sa, sb, out, batch, m, n, k


def mixed_einsum(spec: str, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """``einsum(spec, a, b)`` of bf16 (or float32) operands as a float32
    result with float32 accumulation: jax's ``preferred_element_type=
    jnp.float32``.  On a CPU tensor, the plain version: both operands
    upcast, one float32 einsum (a bf16 x bf16 product is exact in
    float32).  On a CUDA tensor with both operands 16-bit, one
    ``aten::bmm.dtype`` (``_MixedBmm``) on the operands as they are: no
    float32 copy of either, the result never rounded to bf16; with a
    float32 operand, the other upcast and a float32 einsum, as the
    reference promotes mixed operands."""
    if a.device.type == "cpu" or a.dtype == torch.float32 \
            or b.dtype == torch.float32:
        return torch.einsum(spec, a.float(), b.float())
    return as_bmm(spec, a, b, _MixedBmm.apply)


def as_bmm(spec: str, a: torch.Tensor, b: torch.Tensor, bmm
           ) -> torch.Tensor:
    """``einsum(spec, a, b)`` through one ``bmm(a3, b3)``: each operand
    permuted and reshaped to (batch, rows, depth) / (batch, depth,
    columns), the product reshaped and permuted to ``spec``'s output."""
    sa, sb, out, batch, m, n, k = _bmm_plan(spec)
    size = {**dict(zip(sb, b.shape)), **dict(zip(sa, a.shape))}

    def prod(cs):
        return math.prod(size[c] for c in cs)

    a3 = a.permute([sa.index(c) for c in batch + m + k]).reshape(
        prod(batch), prod(m), prod(k))
    b3 = b.permute([sb.index(c) for c in batch + k + n]).reshape(
        prod(batch), prod(k), prod(n))
    r = bmm(a3, b3)
    order = batch + m + n
    return r.reshape([size[c] for c in order]).permute(
        [order.index(c) for c in out])


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, d: int, device=None) -> nn.ParameterDict:
    params = {"scale": _param((d,), torch.float32, device)}
    if cfg.norm == "layernorm":
        params["bias"] = _param((d,), torch.float32, device)
    return nn.ParameterDict(params)


def apply_norm(cfg: ArchConfig, p, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S).
    The head splits into halves (no interleave)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs   # (..., S, hd/2)
    angles = angles[..., None, :]                   # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, d: int, d_ff: int, dtype,
             device=None) -> nn.ParameterDict:
    params = {"w1": _param((d, d_ff), dtype, device)}
    if cfg.act == "silu_gated":
        params["w3"] = _param((d, d_ff), dtype, device)
    params["w2"] = _param((d_ff, d), dtype, device)
    return nn.ParameterDict(params)


def apply_act(cfg: ArchConfig, h: torch.Tensor,
              gate: torch.Tensor | None) -> torch.Tensor:
    if cfg.act == "silu_gated":
        return F.silu(gate) * h
    if cfg.act == "gelu":
        return F.gelu(h, approximate="tanh")
    if cfg.act == "relu_sq":
        return torch.square(F.relu(h))
    raise ValueError(cfg.act)


def apply_mlp(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The MLP on whatever ``p`` holds: with ``w1`` / ``w3`` the rank's
    d_ff columns and ``w2`` its rows, the output is the rank's partial
    sum (:func:`tp_combine` adds the partials up)."""
    h = x @ p["w1"]
    gate = x @ p["w3"] if "w3" in p else None
    return apply_act(cfg, h, gate) @ p["w2"]


def tp_combine(out: torch.Tensor, tp, seq) -> torch.Tensor:
    """A layer's output back in the residual stream's layout.  ``tp``
    (a ``sharding.AxisGroup`` or None): the layer ran on the rank's
    slice of its heads or d_ff, so ``out`` is a partial sum over the
    model axis.  ``seq``: the stream is cut on the sequence over that
    axis (``act_seq``) and the layer ran on the gathered sequence.  So a
    partial output is reduce-scattered back to the rank's sequence block
    (``seq``) or all-reduced (no ``seq``); a whole one (no ``tp``) is cut
    to the rank's block, or kept."""
    from repro_torch.distributed import sharding as shd

    if tp is not None:
        if seq is not None:
            return shd.reduce_scatter(out, 1, seq.group)
        return shd.all_reduce(out, tp.group)
    return shd.seq_slice(out, 1, seq)


# --------------------------------------------------------------------------
# embeddings / logits / loss
# --------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "tok": _param((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                      device),
        "head": _param((cfg.d_model, cfg.vocab_size), cfg.param_dtype,
                       device)})


def embed_tokens(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``p["tok"]``, negative ids counting from the end as
    ``jnp.take`` counts them.  ``F.embedding`` is that gather; its
    backward sums each row's gradients in a fixed order on the card
    (indexing's backward would be an accumulating ``index_put_``)."""
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + p["tok"].shape[0], ids)
    return F.embedding(ids, p["tok"]).to(dtype)


def head_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The loss's float32 logits ``h @ head`` as ``XENT_MM`` computes
    them: "mixed", the operands as they are (:func:`mixed_einsum`: no
    float32 copy of the (D, V) head on the card); "cast", both upcast."""
    if XENT_MM == "mixed":
        return mixed_einsum("bcd,dv->bcv", h, head)
    if XENT_MM != "cast":
        raise ValueError(f"XENT_MM {XENT_MM!r} is not 'mixed' or 'cast'")
    return h.float() @ head.float()


def _xent_chunk(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor,
                tp=None):
    """One chunk's (nll sum, z sum, count, correct) as 0-d float32.
    With ``tp`` (a ``sharding.AxisGroup``) ``head`` is the rank's slice
    of the vocabulary, the ``tp.index``-th: the logsumexp's maximum
    (detached) and its sum of exponentials, and the target logit, are
    added up over the group, and the argmax is the group's, the lowest
    index winning ties as ``argmax`` does.  The head's gradient leaves
    each chunk in its dtype, so a bf16 head's chunk gradients add up in
    bf16, as the reference's scan adds them."""
    logits = head_logits(h, head)                         # (B, c, V)
    lab = lab.long()
    v0 = 0 if tp is None else tp.index * logits.shape[-1]
    hit = torch.arange(v0, v0 + logits.shape[-1],
                       device=logits.device) == lab[..., None]
    tgt = torch.where(hit, logits, 0.0).sum(-1)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)             # (B, c)
        pred = logits.argmax(-1)
    else:
        from repro_torch.distributed import sharding as shd

        best, arg = logits.detach().max(-1)
        top = shd.all_reduce_(best.clone(), tp.group, shd.reduce_op("max"))
        sumexp = torch.exp(logits - top[..., None]).sum(-1)
        lse = torch.log(shd.all_reduce(sumexp, tp.group)) + top
        tgt = shd.all_reduce(tgt, tp.group)
        # each rank's (max, its index): the first rank holding the
        # largest value owns the lowest index among the equal maxima
        pairs = shd.all_gather_dim(torch.stack([best, (arg + v0).float()]),
                                   0, tp.group).reshape(tp.size, 2,
                                                        *best.shape)
        pred = pairs[:, 1].gather(0, pairs[:, 0].argmax(0)[None])[0].long()
    mask = (lab >= 0).float()
    return (((lse - tgt) * mask).sum(), (lse.square() * mask).sum(),
            mask.sum(), ((pred == lab).float() * mask).sum())


def xent_sums(hidden: torch.Tensor, head: torch.Tensor,
              labels: torch.Tensor, *, chunk: int = 1024, tp=None):
    """``chunked_softmax_xent``'s loop: (nll sum, z sum, count, correct)
    as 0-d float32, the first two differentiable.  ``tp``: ``head`` is
    the rank's vocabulary slice (``_xent_chunk``)."""
    B, S, D = hidden.shape
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    hs = hidden.reshape(B, n_chunks, chunk, D)
    ls = labels.reshape(B, n_chunks, chunk)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    loss_sum, z_sum, cnt, correct = zero, zero, zero, zero
    for c in range(n_chunks):
        nll, z, n, hit = checkpoint(_xent_chunk, hs[:, c], head, ls[:, c],
                                    tp, use_reentrant=False)
        loss_sum, z_sum = loss_sum + nll, z_sum + z
        cnt, correct = cnt + n, correct + hit
    return loss_sum, z_sum, cnt, correct


def chunked_softmax_xent(
    hidden: torch.Tensor,     # (B, S, D) final hidden states
    head: torch.Tensor,       # (D, V) output projection
    labels: torch.Tensor,     # (B, S) int32; -1 = masked position
    *,
    chunk: int = 1024,
    z_loss: float = 1e-4,
):
    """Cross entropy with the vocab projection in S-chunks: the
    (B, chunk, V) float32 logits block is the peak, never (B, S, V);
    the head product as ``XENT_MM`` says (:func:`head_logits`).
    Each chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(body)``), so the backward recomputes one chunk's
    logits at a time instead of keeping every chunk's.
    Returns ``(loss, {"nll", "accuracy", "tokens"})`` as 0-d float32."""
    loss_sum, z_sum, cnt, correct = xent_sums(hidden, head, labels,
                                              chunk=chunk)
    cnt = torch.clamp_min(cnt, 1.0)
    loss = loss_sum / cnt + z_loss * z_sum / cnt
    metrics = {"nll": loss_sum / cnt, "accuracy": correct / cnt,
               "tokens": cnt}
    return loss, metrics


def sharded_objective(sums, aux: torch.Tensor, *, z_loss: float = 1e-4):
    """FSDP execution's loss head under the active rules.  ``sums`` are
    this rank's ``xent_sums``, ``aux`` its own router loss.  The ranks
    whose rules are not manual hold the batch's blocks (each block held
    ``dup`` times when the batch is sharded on fewer axes than the
    parameters); one all-reduce of the sums and ``aux`` gives the counts
    the reference divides by, so each rank's objective is its own
    ``(nll + z_loss z) / count`` over the count of all ranks, plus its
    ``aux`` over the rank count, and the ranks' objectives add up to the
    reference's loss.  Returns ``(objective, metrics)``, the metrics the
    reference's (``loss``, ``nll``, ``accuracy``, ``tokens``,
    ``aux_loss``), equal on every rank."""
    from repro_torch.distributed import sharding as shd

    group, n, dup = shd.objective_group(shd.active_rules())
    loss_sum, z_sum, cnt, correct = sums
    vec = torch.stack([loss_sum.detach(), z_sum.detach(), cnt, correct,
                       aux.detach().float()])
    if group is not None:
        shd.all_reduce_(vec, group)
    t_loss, t_z, t_cnt, t_correct, t_aux = vec.unbind()
    t_cnt = torch.clamp_min(t_cnt, 1.0)
    objective = loss_sum / t_cnt + z_loss * z_sum / t_cnt + aux / n
    metrics = {"loss": t_loss / t_cnt + z_loss * t_z / t_cnt + t_aux / n,
               "nll": t_loss / t_cnt, "accuracy": t_correct / t_cnt,
               "tokens": t_cnt / dup, "aux_loss": t_aux / n}
    return objective, metrics
