"""Plain float32 reference of the decoder language models the benchmark
runs: GQA or MLA attention, a dense MLP or a mixture of experts with
capacity-bounded routing, RMSNorm or LayerNorm, and AdamW.

Written from the published architectures as the configuration files
state them (``spec_from_config``), in plain ``torch`` operations, with
no kernel, cache or batching of the program under test: it imports
nothing of it.  Every product runs in float32 with TF32 off
(``float32_matmul``).  ``Numerics(fp8=True)`` rounds both operands of
every product to float8 (e4m3, and e5m2 for the gradients' products)
with a per-tensor scale first: the control, the precision below the
configurations' bfloat16.

Parameters are a dict ``name -> tensor`` in their stored dtype (bf16
weights, float32 norm scales and router), named as ``param_layout``
lists them; each layer's are upcast to float32 when the layer runs, so
the whole model never exists in float32.  The names follow the
program's module paths (``blocks.3.moe.w1``), the one interface the two
share: the benchmark draws the weights (``perfbench.weights``) and hands
each side the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def float32_matmul():
    """TF32 off for the products inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# --------------------------------------------------------------------------
# the configuration
# --------------------------------------------------------------------------

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Spec:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    mlp: str                 # "silu_gated" | "gelu_tanh"
    norm: str                # "rmsnorm" | "layernorm"
    norm_eps: float
    rope_theta: float
    attention: str           # "gqa" | "mla"
    param_dtype: torch.dtype
    kv_lora_rank: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    aux_coef: float = 0.0
    router_z_coef: float = 0.0
    xent_z: float = 1e-4

    @property
    def moe(self) -> bool:
        return self.n_routed > 0


def as_run(cfg: dict) -> dict:
    """A configuration file's keys as the program runs them: the published
    values, each key under ``departures`` replaced by its ``as_run``
    value: what the program runs instead, stated beside the published
    value."""
    out = dict(cfg)
    for key, d in cfg.get("departures", {}).items():
        out[key] = d["as_run"]
    return out


def spec_from_config(cfg: dict) -> Spec:
    """A configuration file (``perfbench/configs/*.json``: the published
    keys, ``departures`` where the program runs a key otherwise, a
    ``model`` block naming the layer kinds, ``assumed`` for what the
    source does not give) as a ``Spec`` of the model as run."""
    cfg = as_run(cfg)
    model, assumed = cfg["model"], cfg.get("assumed", {})
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    moe = cfg.get("n_routed_experts") or 0
    return Spec(
        vocab=cfg["vocab_size"], d_model=d,
        n_layers=cfg["num_hidden_layers"], n_heads=h,
        n_kv_heads=cfg.get("num_key_value_heads") or h,
        head_dim=cfg.get("head_dim") or cfg.get("v_head_dim") or d // h,
        d_ff=cfg["intermediate_size"], mlp=model["mlp"], norm=model["norm"],
        norm_eps=cfg.get("rms_norm_eps", cfg.get("norm_epsilon")), rope_theta=float(cfg["rope_theta"]),
        attention=model["attention"],
        param_dtype=_DTYPES[cfg["torch_dtype"]],
        kv_lora_rank=cfg.get("kv_lora_rank") or 0,
        qk_nope=cfg.get("qk_nope_head_dim") or 0,
        qk_rope=cfg.get("qk_rope_head_dim") or 0,
        v_head=cfg.get("v_head_dim") or 0,
        n_routed=moe, n_shared=cfg.get("n_shared_experts") or 0,
        top_k=cfg.get("num_experts_per_tok") or 0,
        d_ff_expert=cfg.get("moe_intermediate_size") or 0,
        first_dense=cfg.get("first_k_dense_replace") or 0,
        capacity_factor=assumed.get("moe_capacity_factor", 1.25),
        norm_topk=bool(cfg.get("norm_topk_prob", True)),
        aux_coef=assumed.get("aux_loss_coef", 0.0),
        router_z_coef=assumed.get("router_z_loss_coef", 0.0),
        xent_z=assumed.get("xent_z_loss_coef", 1e-4))


# --------------------------------------------------------------------------
# the parameters
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: torch.dtype
    fan_in: int = 0          # normal * fan_in ** -0.5; 0: the constant
    const: float = 0.0


def _norm_leaves(spec: Spec, prefix: str) -> list[Leaf]:
    out = [Leaf(f"{prefix}.scale", (spec.d_model,), torch.float32,
                const=1.0)]
    if spec.norm == "layernorm":
        out.append(Leaf(f"{prefix}.bias", (spec.d_model,), torch.float32))
    return out


def _layer_leaves(spec: Spec, p: str, moe: bool) -> list[Leaf]:
    D, H, dt = spec.d_model, spec.n_heads, spec.param_dtype
    out = _norm_leaves(spec, f"{p}.ln1") + _norm_leaves(spec, f"{p}.ln2")
    if spec.attention == "mla":
        r, qk = spec.kv_lora_rank, spec.qk_nope + spec.qk_rope
        out += [Leaf(f"{p}.attn.wq", (D, H, qk), dt, D),
                Leaf(f"{p}.attn.wdkv", (D, r + spec.qk_rope), dt, D),
                Leaf(f"{p}.attn.wuk", (r, H, spec.qk_nope), dt, r),
                Leaf(f"{p}.attn.wuv", (r, H, spec.v_head), dt, r),
                Leaf(f"{p}.attn.wo", (H, spec.v_head, D), dt,
                     H * spec.v_head)]
    else:
        K, hd = spec.n_kv_heads, spec.head_dim
        out += [Leaf(f"{p}.attn.wq", (D, H, hd), dt, D),
                Leaf(f"{p}.attn.wk", (D, K, hd), dt, D),
                Leaf(f"{p}.attn.wv", (D, K, hd), dt, D),
                Leaf(f"{p}.attn.wo", (H, hd, D), dt, H * hd)]
    if moe:
        E, Fe = spec.n_routed, spec.d_ff_expert
        out += [Leaf(f"{p}.moe.router", (D, E), torch.float32, D),
                Leaf(f"{p}.moe.w1", (E, D, Fe), dt, D),
                Leaf(f"{p}.moe.w3", (E, D, Fe), dt, D),
                Leaf(f"{p}.moe.w2", (E, Fe, D), dt, Fe)]
        if spec.n_shared:
            Fs = spec.n_shared * Fe
            out += [Leaf(f"{p}.moe.sw1", (D, Fs), dt, D),
                    Leaf(f"{p}.moe.sw3", (D, Fs), dt, D),
                    Leaf(f"{p}.moe.sw2", (Fs, D), dt, Fs)]
    else:
        F_ = spec.d_ff
        out.append(Leaf(f"{p}.mlp.w1", (D, F_), dt, D))
        if spec.mlp == "silu_gated":
            out.append(Leaf(f"{p}.mlp.w3", (D, F_), dt, D))
        out.append(Leaf(f"{p}.mlp.w2", (F_, D), dt, F_))
    return out


def layer_prefixes(spec: Spec) -> list[tuple[str, bool]]:
    """(name prefix, is a mixture-of-experts layer) of every layer in the
    order they run: the leading dense layers of a mixture-of-experts
    model first (``pre_blocks``), then the repeated ones (``blocks``)."""
    pre = spec.first_dense if spec.moe else 0
    return ([(f"pre_blocks.{i}", False) for i in range(pre)]
            + [(f"blocks.{i}", spec.moe) for i in range(spec.n_layers - pre)])


def param_layout(spec: Spec) -> list[Leaf]:
    """Every parameter: its name, shape, stored dtype and init."""
    D, V, dt = spec.d_model, spec.vocab, spec.param_dtype
    out = [Leaf("embed.tok", (V, D), dt, D), Leaf("embed.head", (D, V), dt, D)]
    for prefix, moe in layer_prefixes(spec):
        out += _layer_leaves(spec, prefix, moe)
    return out + _norm_leaves(spec, "final_norm")


def decays(name: str, shape) -> bool:
    """Where AdamW decays: every matrix, and every leaf of the repeated
    layers (their tree stacks them on a layer axis, so each is at least
    2-d there: the configuration's optimizer as run)."""
    return name.startswith("blocks.") or len(shape) >= 2


# --------------------------------------------------------------------------
# the numerics: float32, or the float8 control
# --------------------------------------------------------------------------


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with a per-tensor scale that
    puts its largest magnitude at ``top``, back in float32."""
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(torch.float32) * s


class _Fp8Einsum(torch.autograd.Function):
    """``einsum`` of operands rounded to float8 e4m3, its backward's
    products of the gradient rounded to e5m2 and the same rounded
    operands: a float8 training step's products, accumulated in
    float32."""

    @staticmethod
    def forward(ctx, eq, a, b):
        qa = _fp8(a, torch.float8_e4m3fn, 448.0)
        qb = _fp8(b, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        sa, sb = ins.split(",")
        qg = _fp8(g, torch.float8_e5m2, 57344.0)
        return (None, torch.einsum(f"{out},{sb}->{sa}", qg, qb),
                torch.einsum(f"{sa},{out}->{sb}", qa, qg))


class Numerics:
    """Every product of the reference goes through ``ein``: in float32,
    or (``fp8``, the control) with its operands rounded to float8 e4m3
    and, under autograd, its gradient products' operands to e5m2, each
    with a per-tensor scale."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _Fp8Einsum.apply(eq, a, b)
        return torch.einsum(eq, a, b)


# --------------------------------------------------------------------------
# layers (float32)
# --------------------------------------------------------------------------


def norm(spec: Spec, w: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    if spec.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + spec.norm_eps)
                * w[f"{prefix}.scale"] + w[f"{prefix}.bias"])
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + spec.norm_eps) * w[f"{prefix}.scale"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of the head's two halves (no interleave).
    x: (B, S, H, d); positions: (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_block(num: Numerics, q, k, v, q0: int, scale: float):
    """One query block's causal attention: q (bq, H, dk) at positions
    q0.., k (Sk, H, dk), v (Sk, H, dv) at positions 0.. ."""
    s = num.ein("qhd,khd->hqk", q, k) * scale
    qp = torch.arange(q0, q0 + q.shape[0], device=q.device)
    kp = torch.arange(k.shape[0], device=q.device)
    s = s.masked_fill(kp[None, None, :] > qp[None, :, None], float("-inf"))
    return num.ein("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def causal_attention(num: Numerics, q, k, v, scale: float,
                     q_block: int = 1024):
    """softmax(q k^T * scale, causal) v row by row and in query blocks,
    each under ``checkpoint`` when it needs a gradient, so no more than
    one block's (H, bq, Sk) scores live.  q, k: (B, S, H, dk); v: (B,
    S, H, dv).  Returns (B, S, H, dv)."""
    B, S = q.shape[:2]
    grad = torch.is_grad_enabled() and q.requires_grad
    rows = []
    for b in range(B):
        parts = []
        for i in range(0, S, q_block):
            j = min(i + q_block, S)
            args = (num, q[b, i:j], k[b, :j], v[b, :j], i, scale)
            parts.append(checkpoint(_causal_block, *args, use_reentrant=False)
                         if grad else _causal_block(*args))
        rows.append(torch.cat(parts))
    return torch.stack(rows)


def attention(spec: Spec, num: Numerics, w: dict, p: str, x, positions):
    if spec.attention == "mla":
        q = num.ein("bsd,dhk->bshk", x, w[f"{p}.attn.wq"])
        q_nope = q[..., :spec.qk_nope]
        q_rope = rope(q[..., spec.qk_nope:], positions, spec.rope_theta)
        dkv = num.ein("bsd,dr->bsr", x, w[f"{p}.attn.wdkv"])
        c_kv = dkv[..., :spec.kv_lora_rank]
        k_rope = rope(dkv[..., None, spec.kv_lora_rank:], positions,
                      spec.rope_theta)
        k_nope = num.ein("bsr,rhk->bshk", c_kv, w[f"{p}.attn.wuk"])
        v = num.ein("bsr,rhk->bshk", c_kv, w[f"{p}.attn.wuv"])
        H = spec.n_heads
        q_cat = torch.cat([q_nope, q_rope], -1)
        k_cat = torch.cat([k_nope, k_rope.expand(-1, -1, H, -1)], -1)
        scale = (spec.qk_nope + spec.qk_rope) ** -0.5
        o = causal_attention(num, q_cat, k_cat, v, scale)
    else:
        G = spec.n_heads // spec.n_kv_heads
        q = rope(num.ein("bsd,dhk->bshk", x, w[f"{p}.attn.wq"]), positions,
                 spec.rope_theta)
        k = rope(num.ein("bsd,dhk->bshk", x, w[f"{p}.attn.wk"]), positions,
                 spec.rope_theta)
        v = num.ein("bsd,dhk->bshk", x, w[f"{p}.attn.wv"])
        o = causal_attention(num, q, k.repeat_interleave(G, dim=2),
                             v.repeat_interleave(G, dim=2),
                             spec.head_dim ** -0.5)
    return num.ein("bshk,hkd->bsd", o, w[f"{p}.attn.wo"])


def mlp(spec: Spec, num: Numerics, w: dict, p: str, x):
    h = num.ein("td,df->tf", x, w[f"{p}.w1"])
    if spec.mlp == "silu_gated":
        h = F.silu(num.ein("td,df->tf", x, w[f"{p}.w3"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return num.ein("tf,fd->td", h, w[f"{p}.w2"])


def capacity(spec: Spec, n_tokens: int) -> int:
    """Slots per expert: tokens x top_k / experts x the capacity factor,
    rounded up to a multiple of 8, at least 8 and at most the tokens."""
    c = int(n_tokens * spec.top_k / spec.n_routed * spec.capacity_factor)
    return max(8, min(n_tokens, (c + 7) // 8 * 8))


def route(spec: Spec, num: Numerics, w: dict, p: str, x):
    """(gates (T, k), experts (T, k), kept (T, k) bool, aux + z loss).
    The top-k of the router's softmax, largest first and equal values
    lowest expert first; each expert keeps its first ``capacity``
    entries in token order (token t's j-th choice is entry t*k + j)."""
    T, k, E = x.shape[0], spec.top_k, spec.n_routed
    logits = num.ein("td,de->te", x, w[f"{p}.moe.router"])
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    if spec.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    aux = E * torch.sum(counts / (T * k) * probs.mean(0)) * spec.aux_coef
    z = torch.logsumexp(logits, dim=-1).square().mean() * spec.router_z_coef
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    seg_start = torch.searchsorted(flat[order], flat[order], side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=x.device) - seg_start
    kept = (rank < capacity(spec, T)).reshape(T, k)
    return gates, idx, kept, aux + z


def moe(spec: Spec, num: Numerics, w: dict, p: str, x):
    """The routed experts (each on the tokens it kept), gated and added,
    and the shared experts on every token.  x: (T, D)."""
    gates, idx, kept, aux = route(spec, num, w, p, x)
    out = torch.zeros_like(x)
    tok = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    w1, w3, w2 = (w[f"{p}.moe.{k}"].unbind(0) for k in ("w1", "w3", "w2"))
    for e in range(spec.n_routed):
        sel = (idx == e) & kept
        t_e, g_e = tok[sel], gates[sel]
        if not t_e.numel():
            continue
        xe = x[t_e]
        h = F.silu(num.ein("td,df->tf", xe, w3[e])) \
            * num.ein("td,df->tf", xe, w1[e])
        y = num.ein("tf,fd->td", h, w2[e]) * g_e[:, None]
        out = out.index_add(0, t_e, y)
    if spec.n_shared:
        hs = F.silu(num.ein("td,df->tf", x, w[f"{p}.moe.sw3"])) \
            * num.ein("td,df->tf", x, w[f"{p}.moe.sw1"])
        out = out + num.ein("tf,fd->td", hs, w[f"{p}.moe.sw2"])
    return out, aux


def block(spec: Spec, num: Numerics, w: dict, p: str, is_moe: bool, x,
          positions):
    """One layer: pre-norm attention and FFN with residual adds.
    Returns (x, router loss as a 0-d tensor)."""
    x = x + attention(spec, num, w, p, norm(spec, w, f"{p}.ln1", x),
                      positions)
    B, S, D = x.shape
    h = norm(spec, w, f"{p}.ln2", x).reshape(B * S, D)
    if is_moe:
        f, aux = moe(spec, num, w, p, h)
    else:
        f, aux = mlp(spec, num, w, f"{p}.mlp", h), x.new_zeros(())
    return x + f.reshape(B, S, D), aux


def layer_weights(params: dict, prefix: str, grad: bool = False) -> dict:
    """The layer's parameters upcast to float32 (fresh leaves with
    ``grad``)."""
    out = {}
    for n, t in params.items():
        if n.startswith(prefix + "."):
            f = t.detach().float()
            out[n] = f.requires_grad_() if grad else f
    return out


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed.tok"].detach()[tokens.long()].float()


# --------------------------------------------------------------------------
# serving: logits at chosen positions
# --------------------------------------------------------------------------


@torch.no_grad()
def logits_at(spec: Spec, params: dict, tokens: torch.Tensor,
              where: torch.Tensor, num: Numerics | None = None):
    """Float32 logits (len(where), V) at positions ``where`` of one
    sequence ``tokens`` (S,), every position attending to all before it
    and itself, positions counted from 0 at the first token."""
    num = num or Numerics()
    with float32_matmul():
        x = embed(params, tokens[None])
        pos = torch.arange(tokens.shape[0], device=tokens.device)[None]
        for prefix, is_moe in layer_prefixes(spec):
            x, _ = block(spec, num, layer_weights(params, prefix), prefix,
                         is_moe, x, pos)
        h = norm(spec, layer_weights(params, "final_norm"), "final_norm",
                 x[0, where])
        return num.ein("td,dv->tv", h, params["embed.head"].float())


# --------------------------------------------------------------------------
# training: loss, gradients, AdamW
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Opt:
    lr: float
    warmup_steps: int
    total_steps: int
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1

    def lr_at(self, step: int) -> float:
        """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine
        to ``min_lr_frac`` of it at ``total_steps``; ``step`` from 1."""
        if step < self.warmup_steps:
            return self.lr * step / max(self.warmup_steps, 1)
        prog = min(max((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0),
                   1.0)
        return self.lr * (self.min_lr_frac + (1 - self.min_lr_frac) * 0.5
                          * (1 + math.cos(math.pi * prog)))


def opt_from(a: dict) -> Opt:
    """A cell's ``optimizer`` settings as an ``Opt``."""
    return Opt(lr=a["lr"], warmup_steps=a["warmup_steps"],
               total_steps=a["total_steps"], betas=tuple(a["betas"]),
               eps=a["eps"], weight_decay=a["weight_decay"],
               clip_norm=a["clip_norm"], min_lr_frac=a["min_lr_frac"])


def _xent_chunk(num: Numerics, h, head, lab, z: float):
    logits = num.ein("td,dv->tv", h, head)
    lse = torch.logsumexp(logits, dim=-1)
    m = (lab >= 0).float()
    tgt = logits.gather(1, lab.clamp_min(0)[:, None])[:, 0]
    return ((lse - tgt) * m).sum() + z * (lse.square() * m).sum()


class Trainer:
    """The reference's train step on ``params`` (its own stored copy, a
    dict of bf16 / float32 tensors updated in place) with float32 AdamW
    moments.  A step keeps each layer's input, then runs the backward
    twice, layer by layer, each layer recomputed: the first pass sums
    each gradient's squares (the global-norm clip needs them all), the
    second applies the update leaf by leaf, so no whole gradient is
    ever held.  ``step`` returns the loss and each leaf's gradient norm
    as the optimizer takes it (clipped)."""

    def __init__(self, spec: Spec, params: dict, opt: Opt,
                 num: Numerics | None = None, chunk: int = 1024):
        self.spec, self.params, self.opt = spec, params, opt
        self.num = num or Numerics()
        self.chunk = chunk
        self.m = {n: torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for n, t in params.items()}
        self.v = {n: torch.zeros_like(m) for n, m in self.m.items()}
        self.t = 0

    def _head_sums(self, w: dict, x, labels):
        """Summed token losses (nll + z-loss terms) of the final hidden
        states ``x`` (B, S, D), the head in ``chunk``-token blocks."""
        spec, n = self.spec, self.chunk
        h = norm(spec, w, "final_norm", x).reshape(-1, spec.d_model)
        lab = labels.reshape(-1)
        total = h.new_zeros(())
        grad = torch.is_grad_enabled()
        for i in range(0, h.shape[0], n):
            args = (self.num, h[i:i + n], w["embed.head"], lab[i:i + n],
                    spec.xent_z)
            total = total + (checkpoint(_xent_chunk, *args,
                                        use_reentrant=False)
                             if grad else _xent_chunk(*args))
        return total

    def _backward(self, xs: list, tokens, labels, count: float, on_grad):
        """Every leaf's gradient of the loss, ``on_grad(name, grad)``
        called for each as it is ready: the head and final norm, then
        the layers last to first, then the embedding."""
        spec, params = self.spec, self.params
        w = layer_weights(params, "final_norm", grad=True)
        w["embed.head"] = params["embed.head"].detach().float() \
            .requires_grad_()
        x = xs[-1].detach().requires_grad_()
        (self._head_sums(w, x, labels) / count).backward()
        for n, t in w.items():
            on_grad(n, t.grad)
        dx = x.grad
        del w, x
        pos = torch.arange(tokens.shape[1], device=tokens.device).expand(
            tokens.shape[0], -1)
        for i, (prefix, is_moe) in reversed(list(enumerate(
                layer_prefixes(spec)))):
            w = layer_weights(params, prefix, grad=True)
            x = xs[i].detach().requires_grad_()
            y, aux = block(spec, self.num, w, prefix, is_moe, x, pos)
            outs, grads = [y], [dx]
            if aux.requires_grad:
                outs.append(aux)
                grads.append(torch.ones_like(aux))
            torch.autograd.backward(outs, grads)
            for n, t in w.items():
                on_grad(n, t.grad)
            dx = x.grad
            del w, x, y, aux
        tok = params["embed.tok"]
        g = torch.zeros(tok.shape, dtype=torch.float32, device=tok.device)
        g.index_add_(0, tokens.reshape(-1).long(),
                     dx.reshape(-1, spec.d_model))
        on_grad("embed.tok", g)

    def step(self, tokens: torch.Tensor, probe: dict | None = None) -> dict:
        """One step on ``tokens`` (B, S): labels are the next token, the
        last position of each row masked.  ``probe`` (leaf name -> flat
        indices): the gradient's entries there, as the optimizer takes
        them, are returned too."""
        spec, opt = self.spec, self.opt
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -1
        count = float((labels >= 0).sum())
        pos = torch.arange(tokens.shape[1], device=tokens.device).expand(
            tokens.shape[0], -1)
        with float32_matmul():
            with torch.no_grad():
                xs = [embed(self.params, tokens)]
                aux = 0.0
                for prefix, is_moe in layer_prefixes(spec):
                    x, a = block(spec, self.num,
                                 layer_weights(self.params, prefix), prefix,
                                 is_moe, xs[-1], pos)
                    xs.append(x)
                    aux += float(a)
                w = layer_weights(self.params, "final_norm")
                w["embed.head"] = self.params["embed.head"].float()
                loss = float(self._head_sums(w, xs[-1], labels)) / count \
                    + aux
                del w
            sq: dict[str, float] = {}
            picked: dict[str, torch.Tensor] = {}

            def seen(n: str, g: torch.Tensor) -> None:
                sq[n] = float(g.float().square().sum())
                if probe:
                    picked[n] = g.reshape(-1)[probe[n].to(g.device)].cpu()
            self._backward(xs, tokens, labels, count, seen)
            gnorm = math.sqrt(sum(sq.values()))
            scale = min(opt.clip_norm / max(gnorm, 1e-9), 1.0)
            self.t += 1
            self._backward(xs, tokens, labels, count,
                           lambda n, g: self._update(n, g, scale))
        return {"loss": loss, "grad_norm": gnorm,
                "leaf_grad_norms": {n: math.sqrt(s) * scale
                                    for n, s in sq.items()},
                "leaf_grad_samples": {n: g * scale
                                      for n, g in picked.items()}}

    @torch.no_grad()
    def _update(self, name: str, g: torch.Tensor, scale: float) -> None:
        opt, t = self.opt, self.t
        b1, b2 = opt.betas
        p, m, v = self.params[name], self.m[name], self.v[name]
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square(), alpha=1 - b2)
        upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt.eps)
        pf = p.float()
        wd = opt.weight_decay if decays(name, p.shape) else 0.0
        p.copy_(pf - opt.lr_at(t) * (upd + wd * pf))
