"""State-space layers: Mamba2 (SSD, chunked) and RWKV6 ("Finch").

The counterpart of ``repro.models.ssm``.  Both use the chunked
linear-attention form for train and prefill: a loop over chunks carries
the recurrent state while the intra-chunk part is a masked einsum with
decay tensors whose exponents are clipped at 0 before ``exp`` (no
overflow in float32 or bf16 at full width).  Decode is the exact
one-step recurrence, so prefill-then-decode equals one prefill.

Where the port has to choose, it chooses the reference's numbers:

* each chunk step runs under ``torch.utils.checkpoint`` when autograd
  records (the reference wraps it in ``jax.checkpoint``), so a backward
  keeps one chunk's decay tensors at a time;
* RWKV6's exclusive cumsum is ``cum - lw`` and its intra-chunk mask is
  strictly lower; Mamba2's mask includes the diagonal, with the
  inclusive cumsum on both sides;
* the SSD's ``C.B``, which the reference asks with ``preferred_element_
  type=float32``, is a mixed product (``layers.mixed_einsum``); the
  products whose operands it casts to float32 first take them upcast; its
  three-operand einsums are written as two-operand ones (an elementwise
  product, then one contraction), which saves the host a contraction
  path search per call;
* Mamba2's prefill conv is shifted adds in the activation dtype,
  ``x * w[K-1]`` first; decode convolves ``concat(conv_state, x)`` with
  one einsum, and the conv state prefill leaves is the pre-conv,
  pre-silu tail of the x branch;
* RWKV6's ``_lerp`` casts ``mu`` to the carry's dtype, and its decay
  path ``tanh(xw @ wlA) @ wlB`` runs in float32.

A chunk is ``min(chunk, S)`` tokens and ``S`` must be a multiple of it;
the port raises ``ValueError`` where the reference asserts.

Under the model axis (``distributed.sharding``, strategies ``tp_dp``
and ``tp_sp``) each layer runs on the rank's slice of its ``tp`` leaves,
the split read from their block shapes (``sharding.tp_group``; leaves
that must agree and do not raise ``ValueError``):

* Mamba2 splits heads: ``wz`` / ``wx`` / ``conv_w`` / ``norm_scale`` /
  ``wo`` hold the rank's heads, ``wB`` / ``wC`` / ``wdt`` are whole, so
  ``dt`` comes out for every head and is cut to the rank's, as are
  ``dt_bias``, ``A_log`` and ``D_skip`` (inside autograd: their
  gradients are nonzero on the rank's heads, and the sum over the model
  axis adds them up).  The chunk step is per head; the gated norm is
  within a head; ``wo``'s output is a partial sum.
* RWKV6 splits the value head dimension: ``wv`` / ``wg`` /
  ``ln_scale`` / ``wo`` hold the rank's value columns, ``r``, ``k`` and
  the decay are whole, and the WKV state is the rank's (B, H, P,
  P_local) block, with no collective in the chunk step.  The per-head
  norm's mean square over the value dimension adds the ranks' sums of
  squares (``sharding.all_reduce``) over the whole P.  The channel mix
  splits d_ff (``wk_c`` / ``wv_c``) and all-reduces ``h @ wv_c`` before
  the receptance gate multiplies it.

Each partial output is added up by ``layers.tp_combine``, so a layer
returns the whole output on every rank.

Parameters live in ``nn.ParameterDict``s with the reference's leaf
names, shapes and dtypes; the model's ``init`` fills them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import _param, mixed_einsum, tp_combine

# logical-axis specs of each (part, leaf), as ``init_mamba2`` /
# ``init_rwkv6`` give them
SSM_SPECS = {
    ("mamba", "wz"): ("fsdp", "tp", None),
    ("mamba", "wx"): ("fsdp", "tp", None),
    ("mamba", "wB"): ("fsdp", None), ("mamba", "wC"): ("fsdp", None),
    ("mamba", "wdt"): ("fsdp", None), ("mamba", "dt_bias"): (None,),
    ("mamba", "A_log"): (None,), ("mamba", "D_skip"): (None,),
    ("mamba", "conv_w"): (None, "tp", None),
    ("mamba", "norm_scale"): ("tp", None),
    ("mamba", "wo"): ("tp", None, "fsdp"),
    **{("tmix", f"mu_{c}"): (None,) for c in "rkvgw"},
    ("tmix", "wr"): ("fsdp", None, None), ("tmix", "wk"): ("fsdp", None, None),
    ("tmix", "wv"): ("fsdp", None, "tp"), ("tmix", "wg"): ("fsdp", None, "tp"),
    ("tmix", "w0"): (None, None), ("tmix", "wlA"): ("fsdp", None),
    ("tmix", "wlB"): (None, None, None), ("tmix", "u"): (None, None),
    ("tmix", "ln_scale"): (None, "tp"), ("tmix", "wo"): (None, "tp", "fsdp"),
    ("cmix", "mu_ck"): (None,), ("cmix", "mu_cr"): (None,),
    ("cmix", "wk_c"): ("fsdp", "tp"), ("cmix", "wv_c"): ("tp", "fsdp"),
    ("cmix", "wr_c"): ("fsdp", None),
}

# the leaves the reference initialises to a constant, by name; every
# other weight is normal * d_in^-0.5
CONSTANT_INIT = {"dt_bias": 0.0, "A_log": 0.0, "D_skip": 1.0,
                 "norm_scale": 1.0, "w0": -1.0, "u": 0.0, "ln_scale": 1.0,
                 **{f"mu_{c}": 0.5 for c in ("r", "k", "v", "g", "w",
                                             "ck", "cr")}}


def _chunk(S: int, chunk: int) -> int:
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {c}")
    return c


def _scan_chunks(step, state: torch.Tensor, chunks) -> tuple:
    """Run ``step(state, *xs) -> (state, y)`` over the chunks, each
    under ``torch.utils.checkpoint`` when autograd records; returns
    (final state, the ys joined on the sequence axis)."""
    ys = []
    for xs in zip(*chunks):
        if torch.is_grad_enabled():
            state, y = checkpoint(step, state, *xs, use_reentrant=False)
        else:
            state, y = step(state, *xs)
        ys.append(y)
    return state, torch.cat(ys, dim=1)


def _split(p, whole: int, leaves) -> tuple:
    """(``tp`` group or None, the rank's count) of a layer whose split
    dimension of ``whole`` entries is ``leaves[0]``'s; ``leaves`` are
    (name, dimension) pairs that must hold the same count."""
    (name, dim), *rest = leaves
    n = p[name].shape[dim]
    for other, d in rest:
        if p[other].shape[d] != n:
            raise ValueError(f"{other} holds {p[other].shape[d]} of {whole} "
                             f"entries on dimension {d}, {name} {n}: the "
                             "model axis splits them alike")
    return shd.tp_group(whole, n), n


def _shift(x: torch.Tensor, i: int) -> torch.Tensor:
    """x moved ``i`` steps later on axis 1, zeros in front (the
    reference's ``pad(...)[:, :S]``)."""
    pad = [0, 0] * (x.ndim - 2) + [i, 0]
    return F.pad(x, pad)[:, :x.shape[1]]


# ==========================================================================
# Mamba2
# ==========================================================================


def mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return d_in, n_heads, s.head_dim, s.d_state


def init_mamba2(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    s, d = cfg.ssm, cfg.d_model
    _, H, Pd, N = mamba_dims(cfg)
    dt, f32 = cfg.param_dtype, torch.float32
    return nn.ParameterDict({
        "wz": _param((d, H, Pd), dt, device),
        "wx": _param((d, H, Pd), dt, device),
        "wB": _param((d, N), dt, device),
        "wC": _param((d, N), dt, device),
        "wdt": _param((d, H), dt, device),
        "dt_bias": _param((H,), f32, device),
        "A_log": _param((H,), f32, device),
        "D_skip": _param((H,), f32, device),
        "conv_w": _param((s.d_conv, H, Pd), dt, device),
        "norm_scale": _param((H, Pd), f32, device),
        "wo": _param((H, Pd, d), dt, device)})


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: (B,S,H,P); w: (K,H,P)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(1, K):
        out = out + _shift(x, i) * w[K - 1 - i]
    return out


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` at bf16 as XLA computes it: ``x * 1 / (1 +
    exp(-x))``, each step rounded to bf16 (``F.silu`` rounds its bf16
    result once, which moves a bf16 Mamba2 output by a rounding step in
    over half of its entries); ``F.silu`` at float32."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def _mamba_gated_out(p, y: torch.Tensor, z: torch.Tensor, x_dtype):
    yf = y.float()
    ms = yf.square().mean(-1, keepdim=True)
    y = yf * torch.rsqrt(ms + 1e-5) * p["norm_scale"]
    y = y * F.silu(z.float())
    return torch.einsum("bshp,hpd->bsd", y.to(x_dtype), p["wo"])


_MAMBA_TP = (("wz", 1), ("wx", 1), ("conv_w", 1), ("norm_scale", 0),
             ("wo", 0))


def _mamba_heads(cfg: ArchConfig, p) -> tuple:
    """(``tp`` group or None, the rank's head range as a slice)."""
    _, H, _, _ = mamba_dims(cfg)
    tp, n = _split(p, H, _MAMBA_TP)
    h0 = 0 if tp is None else tp.index * n
    return tp, slice(h0, h0 + n)


def _mamba_proj(p, x: torch.Tensor, heads: slice = slice(None)):
    """z and x of the rank's heads (``wz`` / ``wx`` hold them), B and C,
    and ``dt`` cut to ``heads`` from every head's."""
    z = torch.einsum("bsd,dhp->bshp", x, p["wz"])
    xs = torch.einsum("bsd,dhp->bshp", x, p["wx"])
    B_ = x @ p["wB"]
    C_ = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])[..., heads]
    return z, xs, B_, C_, dt


def _ssd_chunk(h0, xk, Bk, Ck, dtk, ak):
    """One SSD chunk: h_t = a_t h_{t-1} + dt_t B_t x_t, y_t = C_t h_t,
    unrolled to y_t = sum_{j<=t} (C_t.B_j) exp(cum_t - cum_j) dt_j x_j
    (the inclusive cumsum on the query side: the diagonal gets exp(0))
    plus the carried state read through exp(cum_t)."""
    c = xk.shape[1]
    xf, Bf, Cf = xk.float(), Bk.float(), Ck.float()
    cum = torch.cumsum(ak, dim=1)                     # (B,c,H) inclusive
    G = mixed_einsum("btn,bsn->bts", Ck, Bk)          # (B,c,c) float32
    dec = torch.exp(torch.clamp_max(cum[:, :, None, :] - cum[:, None, :, :],
                                    0.0))             # (B,t,s,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=xk.device))
    W = G[..., None] * dec * tri[None, :, :, None]
    W = W * dtk[:, None, :, :]                        # weight by dt_j
    y = torch.einsum("btsh,bshp->bthp", W, xf)
    y = y + (torch.einsum("btn,bhpn->bthp", Cf, h0)
             * torch.exp(cum)[..., None])
    last = cum[:, -1][:, None]                        # (B,1,H)
    w_state = torch.exp(torch.clamp_max(last - cum, 0.0)) * dtk
    h1 = (torch.exp(last[:, 0])[:, :, None, None] * h0
          + torch.einsum("bshp,bsn->bhpn", w_state[..., None] * xf, Bf))
    return h1, y


def mamba2_forward(cfg: ArchConfig, p, x: torch.Tensor,
                   state_in: torch.Tensor | None = None,
                   *, state_out: bool = False):
    """Chunked SSD.  x: (B,S,D).  state: (B,H,P,N) float32.  Returns
    (out, None) or, with ``state_out``, (out, {"ssd", "conv"})."""
    s = cfg.ssm
    B, S, _ = x.shape
    _, _, Pd, N = mamba_dims(cfg)
    c = _chunk(S, s.chunk)

    tp, heads = _mamba_heads(cfg, p)
    z, xs_raw, B_, C_, dt = _mamba_proj(p, x, heads)
    xs = _silu(_causal_conv(xs_raw, p["conv_w"]))
    a_log = -torch.exp(p["A_log"][heads]) * dt        # (B,S,H), <= 0

    if state_in is None:
        state_in = torch.zeros((B, xs.shape[2], Pd, N), dtype=torch.float32,
                               device=x.device)
    state, y = _scan_chunks(_ssd_chunk, state_in, [
        t.split(c, dim=1) for t in (xs, B_, C_, dt, a_log)])
    y = y + p["D_skip"][heads][:, None] * xs.float()
    out = tp_combine(_mamba_gated_out(p, y, z, x.dtype), tp, None)
    if state_out:
        conv_state = xs_raw[:, S - (s.d_conv - 1):]   # pre-conv tail
        return out, {"ssd": state, "conv": conv_state}
    return out, None


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    s = cfg.ssm
    _, H, Pd, N = mamba_dims(cfg)
    return {"ssd": torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, H, Pd), dtype=dtype,
                                device=device)}


def mamba2_decode(cfg: ArchConfig, p, x: torch.Tensor, state: dict):
    """One-token recurrence.  x: (B,1,D); the state's heads are the
    rank's.  Returns (out, new state)."""
    tp, heads = _mamba_heads(cfg, p)
    z, xs, B_, C_, dt = _mamba_proj(p, x, heads)
    window = torch.cat([state["conv"], xs.to(state["conv"].dtype)],
                       dim=1)                         # (B, K, H, P)
    xs = _silu(torch.einsum("bkhp,khp->bhp", window, p["conv_w"]))[:, None]
    a = torch.exp(-torch.exp(p["A_log"][heads]) * dt[:, 0])   # (B,H)
    kv = ((xs[:, 0].float() * dt[:, 0, :, None])[..., None]
          * B_[:, 0].float()[:, None, None, :])
    h = a[:, :, None, None] * state["ssd"] + kv
    y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(), h)[:, None]
    y = y + p["D_skip"][heads][:, None] * xs.float()
    out = tp_combine(_mamba_gated_out(p, y, z, x.dtype), tp, None)
    return out, {"ssd": h, "conv": window[:, 1:]}


# ==========================================================================
# RWKV6 (Finch)
# ==========================================================================

_W_LORA = 64


def init_rwkv6(cfg: ArchConfig, device=None):
    """(tmix, cmix) parameter dicts.  The token-shift ``mu_*``, ``w0``,
    the decay LoRA ``wlA`` / ``wlB``, ``u`` and ``ln_scale`` are float32
    whatever the model's dtype, as in the reference."""
    d, H, Pd, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    dt, f32 = cfg.param_dtype, torch.float32
    tmix = {f"mu_{c}": _param((d,), f32, device) for c in "rkvgw"}
    tmix.update({
        "wr": _param((d, H, Pd), dt, device),
        "wk": _param((d, H, Pd), dt, device),
        "wv": _param((d, H, Pd), dt, device),
        "wg": _param((d, H, Pd), dt, device),
        "w0": _param((H, Pd), f32, device),
        "wlA": _param((d, _W_LORA), f32, device),
        "wlB": _param((_W_LORA, H, Pd), f32, device),
        "u": _param((H, Pd), f32, device),
        "ln_scale": _param((H, Pd), f32, device),
        "wo": _param((H, Pd, d), dt, device)})
    cmix = {"mu_ck": _param((d,), f32, device),
            "mu_cr": _param((d,), f32, device),
            "wk_c": _param((d, Fd), dt, device),
            "wv_c": _param((Fd, d), dt, device),
            "wr_c": _param((d, d), dt, device)}
    return nn.ParameterDict(tmix), nn.ParameterDict(cmix)


def _lerp(x: torch.Tensor, x_prev: torch.Tensor,
          mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)      # keep the carry's dtype


def _rwkv_project(p, x: torch.Tensor, x_prev: torch.Tensor):
    """x: (B,S,D); x_prev: the previous token's hidden (B,S,D)."""
    r = torch.einsum("bsd,dhp->bshp", _lerp(x, x_prev, p["mu_r"]), p["wr"])
    k = torch.einsum("bsd,dhp->bshp", _lerp(x, x_prev, p["mu_k"]), p["wk"])
    v = torch.einsum("bsd,dhp->bshp", _lerp(x, x_prev, p["mu_v"]), p["wv"])
    g = torch.einsum("bsd,dhp->bshp", _lerp(x, x_prev, p["mu_g"]), p["wg"])
    xw = _lerp(x, x_prev, p["mu_w"]).float()
    lora = torch.einsum("bsl,lhp->bshp", torch.tanh(xw @ p["wlA"]), p["wlB"])
    logw = -torch.exp(p["w0"] + lora)                 # (B,S,H,P), < 0
    return r, k, v, g, logw


_RWKV_TP = (("wv", 2), ("wg", 2), ("ln_scale", 1), ("wo", 1))


def _rwkv_out(p, wkv: torch.Tensor, g: torch.Tensor, r_dtype, tp=None):
    """The per-head norm, gate and ``wo``.  With ``tp`` the value
    dimension is the rank's slice: the mean square adds the ranks' sums
    of squares, and the output is added up over the group."""
    yf = wkv.float()
    if tp is None:
        ms = yf.square().mean(-1, keepdim=True)
    else:
        ms = shd.all_reduce(yf.square().sum(-1, keepdim=True),
                            tp.group) / (yf.shape[-1] * tp.size)
    y = yf * torch.rsqrt(ms + 1e-5) * p["ln_scale"]
    y = y * F.silu(g.float())
    return tp_combine(torch.einsum("bshp,hpd->bsd", y.to(r_dtype), p["wo"]),
                      tp, None)


def _wkv_chunk(u, S0, rk, kk, vk, lw):
    """One WKV6 chunk.  A[t,j] = sum_p r[t,p] k[j,p] exp(cum_excl[t,p] -
    cum[j,p]) for j < t, the bonus (r_t . (u * k_t)) v_t on the
    diagonal, and the carried state read by r decayed to the chunk
    start."""
    c = rk.shape[1]
    rk, kk, vk = rk.float(), kk.float(), vk.float()
    cum = torch.cumsum(lw, dim=1)                     # (B,c,H,P) inclusive
    cum_excl = cum - lw
    dec = torch.exp(torch.clamp_max(cum_excl[:, :, None] - cum[:, None],
                                    0.0))
    A = torch.einsum("bthp,btjhp->bhtj", rk, kk[:, None] * dec)
    A = A * torch.tril(torch.ones((c, c), dtype=torch.float32,
                                  device=rk.device), diagonal=-1)[None, None]
    bonus = (rk * u * kk).sum(-1)
    y = torch.einsum("bhtj,bjhp->bthp", A, vk)
    y = y + bonus[..., None] * vk
    y = y + torch.einsum("bthp,bhpq->bthq", rk * torch.exp(cum_excl), S0)
    last = cum[:, -1]                                 # (B,H,P)
    S1 = torch.exp(last)[..., None] * S0 + torch.einsum(
        "bjhp,bjhq->bhpq",
        torch.exp(torch.clamp_max(last[:, None] - cum, 0.0)) * kk, vk)
    return S1, y


def rwkv6_tmix(cfg: ArchConfig, p, x: torch.Tensor,
               state_in: torch.Tensor | None = None, *,
               state_out: bool = False):
    """Chunked WKV6.  x: (B,S,D).  state: (B,H,P,P) [k-dim x v-dim]
    float32.  Returns (out, final state or None)."""
    B, S, _ = x.shape
    H, Pd = cfg.n_heads, cfg.head_dim
    c = _chunk(S, cfg.ssm.chunk if cfg.ssm else 32)

    tp, n = _split(p, Pd, _RWKV_TP)
    r, k, v, g, logw = _rwkv_project(p, x, _shift(x, 1))
    if state_in is None:
        state_in = torch.zeros((B, H, Pd, n), dtype=torch.float32,
                               device=x.device)

    def step(S0, rk, kk, vk, lw):
        return _wkv_chunk(p["u"], S0, rk, kk, vk, lw)

    state, wkv = _scan_chunks(step, state_in,
                              [t.split(c, dim=1) for t in (r, k, v, logw)])
    out = _rwkv_out(p, wkv, g, x.dtype, tp)
    return out, (state if state_out else None)


def rwkv6_tmix_decode(cfg: ArchConfig, p, x: torch.Tensor,
                      x_prev: torch.Tensor, state: torch.Tensor):
    """One-step WKV.  x, x_prev: (B,1,D); state: (B,H,P,P), its value
    dimension the rank's.  Returns (out, new state)."""
    tp, _ = _split(p, cfg.head_dim, _RWKV_TP)
    r, k, v, g, logw = _rwkv_project(p, x, x_prev)
    rk, kk, vk = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    w = torch.exp(logw[:, 0])                         # (B,H,P)
    kv = torch.einsum("bhp,bhq->bhpq", kk, vk)
    out_state = state + p["u"][..., None] * kv
    wkv = torch.einsum("bhp,bhpq->bhq", rk, out_state)[:, None]
    new_state = w[..., None] * state + kv
    return _rwkv_out(p, wkv, g, x.dtype, tp), new_state


def rwkv6_cmix(cfg: ArchConfig, p, x: torch.Tensor,
               x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Channel mix with token shift.  x: (B,S,D).  With ``wk_c`` /
    ``wv_c`` the rank's d_ff slice, ``h @ wv_c`` is added up over the
    model axis before the gate multiplies it."""
    if x_prev is None:
        x_prev = _shift(x, 1)
    tp, _ = _split(p, cfg.d_ff, (("wk_c", 1), ("wv_c", 0)))
    xk = _lerp(x, x_prev, p["mu_ck"])
    xr = _lerp(x, x_prev, p["mu_cr"])
    h = torch.square(F.relu(xk @ p["wk_c"]))
    return torch.sigmoid(xr @ p["wr_c"]) * tp_combine(h @ p["wv_c"], tp,
                                                      None)
