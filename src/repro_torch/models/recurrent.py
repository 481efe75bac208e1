"""Recurrent-family models: RWKV6 (attention-free) and Zamba2 (hybrid).

The counterpart of ``repro.models.recurrent``, with the interface of
``models.transformer.TransformerLM`` (``init``, ``abstract``, ``loss``,
``abstract_cache``, ``init_cache``, ``prefill``, ``decode_step``), so
the serve engine and the trainer take either unchanged.

RWKV6: ``blocks`` is a ``ModuleList`` of time-mix / channel-mix blocks
behind the embedding and an input layernorm ``ln_in``; its decode cache
is the per-layer WKV state ``wkv`` (L, B, H, P, P) float32 and the
normed inputs of the last token to each mix, ``tprev`` and ``cprev``
(L, B, D), which the token shift reads.

Zamba2: ``mamba`` holds G groups of K Mamba2 layers (``mamba.g.k``,
stacked on (G, K) in the reference's tree), and one ``shared``
attention + MLP block runs after every group: one set of weights used G
times, each use with its own slice of the KV cache (``k``/``v``
(G, B, S, K, hd)), whose gradients add into the one parameter.  Its
cache also holds each layer's SSD state ``ssd`` (G, K, B, H, P, N)
float32 and conv tail ``conv`` (G, K, B, d_conv - 1, H, P).

In ``loss`` the ``remat`` policy wraps each RWKV block and each Zamba
group (K Mamba2 layers and the shared block), as the reference's
``_remat`` wraps its scan bodies; inside, every chunk step is
checkpointed on its own (``models.ssm``).  Under FSDP execution each
block or group gathers its parameters inside that region, zamba's
shared block at each of its G uses (``models.transformer``).
``decode_step`` writes the new state into the cache it is given, in
place, and returns it with ``pos + 1``.

Under the model axis (strategies ``tp_dp`` and ``tp_sp``) the layers
run on the rank's slices (``models.ssm``; zamba's shared block splits
its attention heads and MLP as ``TransformerLM`` does) and return whole
outputs, so the residual stream stays whole on every rank of the model
axis.  Serving under rules follows ``TransformerLM``: ``prefill`` and
``decode_step`` take the whole batch, cut it over "dp" and return whole
logits; the cache is the rank's block of the reference's specs (``wkv``
on its value dimension, ``ssd`` / ``conv`` on heads, zamba's ``k`` /
``v`` on the sequence over "sp", or over every axis at batch 1;
``tprev`` / ``cprev`` whole).  A recurrent scan runs the whole
sequence, so a residual stream cut on it (``act_seq``, strategy
``megatron_sp``) raises ``NotImplementedError``, as the reference never
pairs them.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import gathered, hint
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_mlp,
    init_norm,
    tp_combine,
)
from repro_torch.models.transformer import (PARAM_SPECS, LanguageModel,
                                            _remat)

SPECS = {**PARAM_SPECS, **ssm.SSM_SPECS,
         **{(part, k): (None,) for part in ("ln_in", "ln")
            for k in ("scale", "bias")}}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class _Recurrent(LanguageModel):
    """What both models add: the SSM leaves' specs and constants, the
    loss head and the cache's allocation."""

    SPECS = SPECS
    CONSTANTS = ssm.CONSTANT_INIT

    def _whole_seq(self) -> None:
        """Refuse a residual stream cut on the sequence (``act_seq``)."""
        seq = self._seq()
        if seq is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the residual stream cut on the sequence "
                f"over {seq.size} ranks (act_seq, strategy "
                f"{shd.active_rules().strategy!r}): a recurrent scan runs "
                "the whole sequence")

    def refuse_compressed_model_axis(self, rules) -> None:
        """No run of the reference holds a recurrent family's split
        layers under the compressed step, so it refuses them."""
        raise NotImplementedError(
            f"{self.cfg.name}: the compressed step over a model axis of "
            f"{shd.axes_size(rules.mesh, rules.table['tp'])} (strategy "
            f"{rules.strategy!r}) does not run a recurrent family's "
            "tensor-parallel layers")

    def _loss_head(self, h: torch.Tensor, labels: torch.Tensor):
        return self._objective(h, labels, torch.zeros(
            (), dtype=torch.float32, device=h.device))

    def _put(self, cache: dict, key: str, index, value: torch.Tensor,
             lead: tuple) -> None:
        """``cache[key][index] = value``, the leaf made at its first write
        in the abstract cache's dtype with ``lead`` stacked axes in front
        of the value's shape (the rank's block)."""
        if key not in cache:
            dtype = self.abstract_cache(1, 1)[0][key].dtype
            cache[key] = torch.empty((*lead, *value.shape), dtype=dtype,
                                     device=value.device)
        cache[key][index] = value


# ==========================================================================
# RWKV6
# ==========================================================================


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg, cfg.d_model, device)
        self.ln2 = init_norm(cfg, cfg.d_model, device)
        self.tmix, self.cmix = ssm.init_rwkv6(cfg, device)


class RWKVModel(_Recurrent):
    def __init__(self, cfg: ArchConfig, remat: str = "full",
                 device="cuda"):
        super().__init__(cfg, remat, device)
        self.ln_in = init_norm(cfg, cfg.d_model, device)
        self.blocks = nn.ModuleList(RWKVBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg, cfg.d_model, device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = embed_tokens(self.embed, tokens, cfg.compute_dtype)
        return apply_norm(cfg, self.ln_in, h)

    def _block(self, blk: RWKVBlock, h, collect: bool = False):
        """(h, (wkv state, last normed tmix input, last normed cmix
        input) or None)."""
        cfg = self.cfg
        a_in = apply_norm(cfg, blk.ln1, h)
        t_out, wkv = ssm.rwkv6_tmix(cfg, blk.tmix, a_in, state_out=collect)
        h = hint(h + t_out, "dp", "act_seq", None)
        m_in = apply_norm(cfg, blk.ln2, h)
        h = hint(h + ssm.rwkv6_cmix(cfg, blk.cmix, m_in), "dp", "act_seq",
                 None)
        return h, ((wkv, a_in[:, -1], m_in[:, -1]) if collect else None)

    def _train_block(self, blk: RWKVBlock, h):
        with gathered(blk):
            return self._block(blk, h)[0]

    def loss(self, batch):
        self._whole_seq()
        with gathered(self.embed, "tok"), gathered(self.ln_in):
            h = self._embed(batch["tokens"])
        block = _remat(self._train_block, self.remat)
        for blk in self.blocks:
            h = block(blk, h)
        return self._loss_head(h, batch["labels"])

    # ------------------------------------------------------------ serve
    def abstract_cache(self, batch: int, max_seq: int):
        """The cache as meta tensors, and its logical-axis specs (no
        leaf has a sequence axis: ``max_seq`` is unused)."""
        cfg = self.cfg
        L, H, Pd, D = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        bdp = None if batch == 1 else "dp"
        cache = {"wkv": _meta((L, batch, H, Pd, Pd), torch.float32),
                 "tprev": _meta((L, batch, D), cfg.compute_dtype),
                 "cprev": _meta((L, batch, D), cfg.compute_dtype),
                 "pos": _meta((), torch.int32)}
        specs = {"wkv": (None, bdp, None, None, "tp"),
                 "tprev": (None, bdp, None), "cprev": (None, bdp, None),
                 "pos": ()}
        return cache, specs

    def _serve_embed(self, tokens: torch.Tensor):
        """(dp group, the rank's embedded and normed tokens) of a whole
        serving batch."""
        self._whole_seq()
        dp, _ = self._serve_groups(tokens.shape[0])
        tokens = self._rank_batch({"tokens": tokens})["tokens"]
        with gathered(self.embed, "tok"), gathered(self.ln_in):
            return dp, self._embed(tokens)

    def prefill(self, batch, max_seq: int | None = None):
        """Process a full prompt; returns (last-token logits, cache).  No
        leaf has a sequence axis: ``max_seq`` is unused.  Under active
        rules ``batch`` is the whole batch; the cache is the rank's block
        and the logits whole."""
        dp, h = self._serve_embed(batch["tokens"])
        L = len(self.blocks)
        cache: dict = {}
        for i, blk in enumerate(self.blocks):
            with gathered(blk):
                h, (wkv, tprev, cprev) = self._block(blk, h, collect=True)
            for key, value in (("wkv", wkv), ("tprev", tprev),
                               ("cprev", cprev)):
                self._put(cache, key, i, value, (L,))
        cache["pos"] = torch.tensor(batch["tokens"].shape[1],
                                    dtype=torch.int32, device=h.device)
        return self._serve_logits(h, dp), cache

    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """tokens: (B, 1) int32.  Returns (logits (B, V), cache), the
        cache's entries written in place.  Under active rules ``tokens``
        are the whole batch's and ``cache`` the rank's block."""
        cfg = self.cfg
        dp, h = self._serve_embed(tokens)
        wkv, tprev, cprev = cache["wkv"], cache["tprev"], cache["cprev"]
        for i, blk in enumerate(self.blocks):
            with gathered(blk):
                a_in = apply_norm(cfg, blk.ln1, h)
                t_out, state = ssm.rwkv6_tmix_decode(
                    cfg, blk.tmix, a_in, tprev[i][:, None].to(a_in.dtype),
                    wkv[i])
                h = h + t_out
                m_in = apply_norm(cfg, blk.ln2, h)
                h = h + ssm.rwkv6_cmix(cfg, blk.cmix, m_in,
                                       cprev[i][:, None].to(m_in.dtype))
            wkv[i].copy_(state)
            tprev[i].copy_(a_in[:, 0])
            cprev[i].copy_(m_in[:, 0])
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = cache["pos"] + 1
        return self._serve_logits(h, dp), new_cache


# ==========================================================================
# Zamba2 hybrid
# ==========================================================================


class MambaLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = init_norm(cfg, cfg.d_model, device)
        self.mamba = ssm.init_mamba2(cfg, device)


class SharedBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg, cfg.d_model, device)
        self.attn = attn.init_attention(cfg, device)
        self.ln2 = init_norm(cfg, cfg.d_model, device)
        self.mlp = init_mlp(cfg, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            device)


class ZambaModel(_Recurrent):
    def __init__(self, cfg: ArchConfig, remat: str = "full",
                 device="cuda"):
        if cfg.ssm is None or not cfg.ssm.attn_every:
            raise ValueError(f"{cfg.name}: a hybrid needs ssm.attn_every")
        super().__init__(cfg, remat, device)
        self.n_inner = cfg.ssm.attn_every                     # K = 6
        self.n_groups = cfg.n_layers // self.n_inner          # G = 9
        self.mamba = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, device)
                          for _ in range(self.n_inner))
            for _ in range(self.n_groups))
        self.shared = SharedBlock(cfg, device)
        self.final_norm = init_norm(cfg, cfg.d_model, device)

    def _shared_fwd(self, h, positions, kv_out: bool = False):
        cfg, sh = self.cfg, self.shared
        a_in = hint(apply_norm(cfg, sh.ln1, h), "dp", None, None)
        a_out, kv = attn.gqa_forward(cfg, sh.attn, a_in, positions,
                                     kv_out=kv_out)
        h = hint(h + self._heads_tp(a_out), "dp", "act_seq", None)
        m_in = apply_norm(cfg, sh.ln2, h)
        h = hint(h + self._mlp_tp(apply_mlp(cfg, sh.mlp, m_in)), "dp",
                 "act_seq", None)
        return h, kv

    def _heads_tp(self, out: torch.Tensor) -> torch.Tensor:
        """The shared attention's output added up over the model axis
        where its heads are split."""
        return tp_combine(out, attn.head_split(self.cfg, self.shared.attn)[0],
                          None)

    def _mlp_tp(self, out: torch.Tensor) -> torch.Tensor:
        """The shared MLP's output added up where its d_ff is split."""
        tp = shd.tp_group(self.cfg.d_ff, self.shared.mlp["w1"].shape[1])
        return tp_combine(out, tp, None)

    def _group(self, layers: nn.ModuleList, h, positions,
               collect: bool = False):
        """K Mamba2 layers, then the shared block: (h, each layer's
        state or None, the shared block's (k, v) or None)."""
        cfg = self.cfg
        states = []
        for lyr in layers:
            out, state = ssm.mamba2_forward(
                cfg, lyr.mamba, apply_norm(cfg, lyr.ln, h),
                state_out=collect)
            h = hint(h + out, "dp", "act_seq", None)
            states.append(state)
        h, kv = self._shared_fwd(h, positions, kv_out=collect)
        return h, states, kv

    def _train_group(self, layers: nn.ModuleList, h, positions):
        """One group and a use of the shared block; under FSDP execution
        the shared block is gathered at each of its G uses, and autograd
        adds the uses' reduce-scattered gradients into its one block."""
        with gathered(layers), gathered(self.shared):
            return self._group(layers, h, positions)[0]

    def loss(self, batch):
        cfg = self.cfg
        self._whole_seq()
        with gathered(self.embed, "tok"):
            h = hint(embed_tokens(self.embed, batch["tokens"],
                                  cfg.compute_dtype), "dp", "act_seq", None)
        positions = self._positions(h)
        group = _remat(self._train_group, self.remat)
        for layers in self.mamba:
            h = group(layers, h, positions)
        return self._loss_head(h, batch["labels"])

    # ------------------------------------------------------------ serve
    def abstract_cache(self, batch: int, max_seq: int):
        """The cache as meta tensors, and its logical-axis specs."""
        cfg = self.cfg
        G, Kn = self.n_groups, self.n_inner
        _, H, Pd, N = ssm.mamba_dims(cfg)
        K, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.compute_dtype
        bdp = None if batch == 1 else "dp"
        sp = "all" if batch == 1 else "sp"
        cache = {
            "ssd": _meta((G, Kn, batch, H, Pd, N), torch.float32),
            "conv": _meta((G, Kn, batch, cfg.ssm.d_conv - 1, H, Pd), dt),
            "k": _meta((G, batch, max_seq, K, hd), dt),
            "v": _meta((G, batch, max_seq, K, hd), dt),
            "pos": _meta((), torch.int32)}
        specs = {"ssd": (None, None, bdp, "tp", None, None),
                 "conv": (None, None, bdp, None, "tp", None),
                 "k": (None, bdp, sp, None, None),
                 "v": (None, bdp, sp, None, None),
                 "pos": ()}
        return cache, specs

    def _serve_embed(self, tokens: torch.Tensor):
        """(dp and sp groups, the rank's embedded tokens) of a whole
        serving batch."""
        self._whole_seq()
        dp, sp = self._serve_groups(tokens.shape[0])
        tokens = self._rank_batch({"tokens": tokens})["tokens"]
        with gathered(self.embed, "tok"):
            return dp, sp, embed_tokens(self.embed, tokens,
                                        self.cfg.compute_dtype)

    def prefill(self, batch, max_seq: int | None = None):
        """Process a full prompt; returns (last-token logits, cache), the
        attention cache ``max_seq`` positions long (default: the
        prompt's), zeros past the prompt.  Under active rules ``batch``
        is the whole batch; the cache is the rank's block and the logits
        whole."""
        cfg = self.cfg
        dp, sp, h = self._serve_embed(batch["tokens"])
        S = h.shape[1]
        S_loc, lo, hi, past = self._seq_block(S, max_seq, sp)
        positions = self._positions(h)
        G, Kn = self.n_groups, self.n_inner
        alloc = torch.zeros if past else torch.empty
        kv_cache = {key: alloc((G, h.shape[0], S_loc, cfg.n_kv_heads,
                                cfg.head_dim), dtype=cfg.compute_dtype,
                               device=h.device) for key in ("k", "v")}
        cache: dict = {}
        for g, layers in enumerate(self.mamba):
            with gathered(layers), gathered(self.shared):
                h, states, kv = self._group(layers, h, positions,
                                            collect=True)
            for j, state in enumerate(states):
                for key in ("ssd", "conv"):
                    self._put(cache, key, (g, j), state[key], (G, Kn))
            if hi > lo:
                for key, x in zip(("k", "v"), kv):
                    kv_cache[key][g, :, :hi - lo] = x[:, lo:hi]
        cache.update(kv_cache)
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=h.device)
        return self._serve_logits(h, dp), cache

    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """tokens: (B, 1) int32.  Returns (logits (B, V), cache), the
        cache's entries written in place.  Under active rules ``tokens``
        are the whole batch's and ``cache`` the rank's block."""
        cfg, sh = self.cfg, self.shared
        pos = cache["pos"]
        dp, sp, h = self._serve_embed(tokens)
        ssd, conv = cache["ssd"], cache["conv"]
        for g, layers in enumerate(self.mamba):
            with gathered(layers):
                for j, lyr in enumerate(layers):
                    out, state = ssm.mamba2_decode(
                        cfg, lyr.mamba, apply_norm(cfg, lyr.ln, h),
                        {"ssd": ssd[g, j], "conv": conv[g, j]})
                    h = h + out
                    ssd[g, j].copy_(state["ssd"])
                    conv[g, j].copy_(state["conv"])
            with gathered(sh):
                a_in = apply_norm(cfg, sh.ln1, h)
                h = h + attn.gqa_decode(cfg, sh.attn, a_in, pos,
                                        cache["k"][g], cache["v"][g],
                                        sp=sp)[0]
                h = h + self._mlp_tp(apply_mlp(cfg, sh.mlp,
                                               apply_norm(cfg, sh.ln2, h)))
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        return self._serve_logits(h, dp), new_cache
