"""Model assembly: the decoder stack of the dense, moe, audio and vlm
families.

The counterpart of ``repro.models.transformer.TransformerLM``:

  model = build_model(cfg, remat=..., device=...)  # models.archs
  model.init(generator)                      # seeded, in place
  shapes, specs = model.abstract()           # meta tensors + specs
  loss, metrics = model.loss(batch)          # forward + chunked CE + aux
  logits, cache = model.prefill(batch)       # build the decode cache
  logits, cache = model.decode_step(tokens, cache)
  cache, cache_specs = model.abstract_cache(B, S)   # meta tensors + specs

Layers are ``Block`` modules in an ``nn.ModuleList``, run one after the
other (the reference scans one stacked block).  A block's attention is
GQA or MLA (``cfg.attention``) and its FFN a dense MLP or, in the
``moe`` family, a mixture of experts (``models.moe``).  The moe family's
leading ``first_dense`` layers are dense ``pre_blocks``, run before the
stack and first in the cache, as in the reference.  In ``loss`` each
stacked block runs under the ``remat`` policy: ``"none"``, ``"full"``
(``torch.utils.checkpoint``: the backward recomputes the block) or
``"dots"`` (selective checkpointing that saves the outputs of matrix
products without batch dimensions, jax's
``dots_with_no_batch_dims_saveable``); the pre-blocks run without one,
as the reference runs them.  Each block returns its router loss beside
the hidden state, and ``loss`` adds their sum (``aux_loss``).  Each
block's attention and FFN, and the head, are the spans ``model.attn``,
``model.ffn`` and ``model.head`` (``repro_torch.obs``) with the block's
``layer`` (the head's is ``n_layers``): with device intervals in
``loss``'s forward and in ``prefill``, host time alone in
``decode_step``.

Under FSDP execution (parameters cut by ``train.steps.
shard_train_state``, rules active) ``loss`` runs each block with its
parameters gathered whole at use, inside the ``remat`` region
(``sharding.gathered``), as are the embedding, final norm and head;
the batch is the rank's block (``inputs.shard_batch``) and the
objective is the rank's share of the reference's loss
(``layers.sharded_objective``), its metrics the reference's.

The decode cache is the reference's: a dict of stacked tensors — ``k``
and ``v`` ``(L, B, S, K, hd)`` for GQA (int8 plus ``(L, B, S, K)``
float32 ``k_scale``/``v_scale`` when ``KV_CACHE_QUANT``), MLA's latent
``ckv`` ``(L, B, S, r)`` and ``krope`` ``(L, B, S, rope)`` — and a 0-d
int32 ``pos``, so its KV pages have the reference's keys and bytes.
``decode_step`` writes the new token's entries into the cache it is
given, in place, and returns it with ``pos + 1``.

``params_from_reference`` / ``params_to_reference`` move weights from
and to the reference's params tree (numpy leaves, ``blocks`` stacked on
a leading L axis, ``pre_blocks`` a list of per-layer trees);
``train_state_from_reference`` / ``train_state_to_reference`` do the
same for a whole train state (params, AdamW moments and step).  They,
``init_params_`` and ``reference_abstract`` serve every model class:
a parameter's name gives its place in the reference's tree
(``reference_path``), so the recurrent models' trees (zamba's ``mamba``
stacked on (G, K)) need nothing of their own.
"""

from __future__ import annotations

import contextvars
import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import gathered, is_sharded
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    chunked_softmax_xent,
    dense_init_,
    embed_tokens,
    init_embed,
    init_mlp,
    init_norm,
    sharded_objective,
    tp_combine,
    xent_sums,
)
from repro_torch.models.moe import SPECS as MOE_SPECS
from repro_torch.models.moe import init_moe, moe_ffn

# int8 KV cache for GQA decode (per-(token, kv-head) symmetric scales)
KV_CACHE_QUANT = False

REMAT_POLICIES = ("none", "dots", "full")

# logical-axis specs of each (part, leaf), as the reference's init
# functions give them (``blocks`` leaves get a leading None for L); a
# model's own ``SPECS`` take the GQA layers' from ``attention.
# attention_specs`` when it is built (the reference's ``HEAD_TP``)
PARAM_SPECS = {
    ("embed", "tok"): ("fsdp", None), ("embed", "head"): ("fsdp", "tp"),
    **{(part, k): (None,) for part in ("ln1", "ln2", "final_norm")
       for k in ("scale", "bias")},
    ("attn", "wq"): ("fsdp", "tp", None), ("attn", "wk"): ("fsdp", None, None),
    ("attn", "wv"): ("fsdp", None, None), ("attn", "wo"): ("tp", None, "fsdp"),
    ("attn", "wdkv"): ("fsdp", None), ("attn", "wuk"): (None, "tp", None),
    ("attn", "wuv"): (None, "tp", None),
    ("mlp", "w1"): ("fsdp", "tp"), ("mlp", "w3"): ("fsdp", "tp"),
    ("mlp", "w2"): ("tp", "fsdp"),
    **{("moe", k): spec for k, spec in MOE_SPECS.items()},
}
BLOCK_PARTS = ("ln1", "ln2", "attn", "mlp", "moe")


def _dots_policy(ctx, op, *args, **kwargs):
    """Save what a matrix product without batch dimensions outputs (an
    einsum without one runs as a ``bmm`` of batch 1); recompute the
    rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the ``policy``.  Each call runs in a copy of the
    caller's context, and so does its recompute: on the card the
    backward (and so the recompute) runs on the autograd engine's own
    thread, where the caller's context variables (the active
    ``MeshRules``) are not set.  The recompute runs under
    ``obs.quiet()``: its spans and counters were taken in the
    forward."""
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        calls = 0

        def once(*a):
            nonlocal calls
            calls += 1
            if calls == 1:
                return fn(*a)
            with obs.quiet():
                return fn(*a)
        return checkpoint(contextvars.copy_context().run, once, *args,
                          use_reentrant=False, **kw)
    return run


def fan_in(part: str, leaf: str, shape) -> int:
    """The contraction width d_in of a weight's ``normal * d_in^-0.5``
    init, as the reference's init functions pass it: ``tok`` by d_model,
    ``wo`` (H, hd, D) by H * hd, the experts' (E, d_in, d_out) by their
    middle axis, every other weight by its first."""
    if leaf == "tok":
        return shape[1]
    if leaf == "wo":
        return shape[0] * shape[1]
    if part == "moe" and len(shape) == 3:
        return shape[1]
    return shape[0]


class Block(nn.Module):
    """One decoder layer: pre-norm attention (GQA or MLA) and an MLP or
    mixture of experts, residual adds."""

    def __init__(self, cfg: ArchConfig, moe_layer: bool, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg, cfg.d_model, device)
        self.ln2 = init_norm(cfg, cfg.d_model, device)
        self.attn = (attn.init_mla(cfg, device) if cfg.attention == "mla"
                     else attn.init_attention(cfg, device))
        if moe_layer:
            self.moe = init_moe(cfg, device)
        else:
            self.mlp = init_mlp(cfg, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                                device)


class LanguageModel(nn.Module):
    """What every model class shares: the config, the ``remat`` policy
    and the embedding; the seeded init of ``CONSTANTS`` and weights;
    ``abstract()`` by ``SPECS``; positions, last-token logits and a zero
    cache.  Subclasses add ``final_norm`` and the rest."""

    SPECS: dict = {}                 # (part, leaf) -> logical-axis spec
    CONSTANTS: dict[str, float] = {}  # leaves initialised to a constant

    def __init__(self, cfg: ArchConfig, remat: str, device):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r} is not one of "
                             f"{REMAT_POLICIES}")
        self.cfg = cfg
        self.remat = remat
        # fixed at build, as the reference's init returns them
        self.SPECS = {**type(self).SPECS, **attn.attention_specs(cfg)}
        self.embed = init_embed(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def init(self, generator: torch.Generator):
        """Norm scales 1, biases 0 and ``CONSTANTS`` their value; every
        other weight normal * d_in^-0.5, drawn in float32 from
        ``generator`` (on the model's device) and cast, d_in being the
        weight's contraction width (``fan_in``)."""
        init_params_(self, generator, self.CONSTANTS)
        return self

    def abstract(self):
        """(params as meta tensors, logical-axis specs), both in the
        reference's tree layout (``reference_path``)."""
        return reference_abstract(self, self.SPECS)

    def _positions(self, h: torch.Tensor, ways: int = 1) -> torch.Tensor:
        """Positions of the whole sequence, ``ways`` times ``h``'s."""
        B, S = h.shape[0], h.shape[1] * ways
        return torch.arange(S, dtype=torch.int32,
                            device=h.device).expand(B, S)

    @staticmethod
    def _seq():
        """The ``act_seq`` group of the active rules: the residual
        stream is cut on the sequence over it (None: whole)."""
        return shd.logical_group(shd.active_rules(), "act_seq")

    def refuse_compressed_model_axis(self, rules) -> None:
        """Raise ``NotImplementedError`` where the compressed step
        (``distributed.compression``) must not run this model's layers
        split over the model axis of ``rules``; these it runs."""

    def _objective(self, h: torch.Tensor, labels: torch.Tensor,
                   aux: torch.Tensor):
        """(loss, metrics) of the last hidden state: final norm, chunked
        cross entropy and the router loss ``aux``; under FSDP execution
        the rank's share (``layers.sharded_objective``), the sequence
        gathered first where it is cut, the head vocabulary-parallel
        where it is split."""
        with gathered(self.final_norm), gathered(self.embed, "head"), \
                obs.span("model.head", device=h.device,
                         layer=self.cfg.n_layers):
            h = apply_norm(self.cfg, self.final_norm, h)
            if is_sharded(self.embed["tok"]):
                seq = self._seq()
                h = shd.all_gather(h, 1, seq and seq.group)
                head = self.embed["head"]
                tp = shd.tp_group(self.cfg.vocab_size, head.shape[1])
                return sharded_objective(
                    xent_sums(h, head, labels, tp=tp), aux)
            loss, metrics = chunked_softmax_xent(h, self.embed["head"],
                                                 labels)
        metrics["aux_loss"] = aux
        return loss + aux, metrics

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Last-position logits in float32 against a float32 head."""
        h = apply_norm(self.cfg, self.final_norm, h)
        return h[:, -1].float() @ self.embed["head"].float()

    def init_cache(self, batch: int, max_seq: int) -> dict:
        shapes, _ = self.abstract_cache(batch, max_seq)
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in shapes.items()}

    # ------------------------------------------------ serving under rules
    @staticmethod
    def _serve_groups(batch: int):
        """(dp, sp) groups of a serving batch of ``batch`` sequences: the
        batch cut over "dp" and the cache's sequence over "sp", or, for
        one sequence, the batch whole and the sequence over every axis
        (the reference's ``abstract_cache`` specs)."""
        rules = shd.active_rules()
        if batch == 1:
            return None, shd.logical_group(rules, "all")
        return (shd.logical_group(rules, "dp"),
                shd.logical_group(rules, "sp"))

    @staticmethod
    def _rank_batch(batch: dict) -> dict:
        """This rank's block of a whole serving batch over "dp"."""
        rules = shd.active_rules()
        if rules is None:
            return batch
        from repro_torch.models.inputs import shard_batch
        return shard_batch(batch, rules)

    def _serve_logits(self, h: torch.Tensor, dp) -> torch.Tensor:
        """The last position's logits, whole (B, V) on every rank: the
        sequence gathered where it is cut, the vocabulary slices and the
        batch blocks all-gathered."""
        seq = self._seq()
        h = shd.all_gather(h, 1, seq and seq.group)
        with gathered(self.final_norm), gathered(self.embed, "head"):
            logits = self._logits(h)
            tp = shd.tp_group(self.cfg.vocab_size,
                              self.embed["head"].shape[1])
        if tp is not None:
            logits = shd.all_gather_dim(logits, 1, tp.group)
        if dp is not None:
            logits = shd.all_gather_dim(logits, 0, dp.group)
        return logits

    @staticmethod
    def _seq_block(S: int, max_seq: int | None, sp) -> tuple:
        """(positions a rank's cache block holds, the prompt's part of
        them as [lo, hi) in the prompt, whether the block reaches past
        the prompt) of a ``max_seq`` cache (default: the prompt's ``S``)
        cut over ``sp``."""
        n, at = (1, 0) if sp is None else (sp.size, sp.index)
        total = max_seq or S
        if total < S or total % n:
            raise ValueError(f"a cache of {total} positions for a prompt of "
                             f"{S} in {n} blocks")
        S_loc = total // n
        lo, hi = at * S_loc, min((at + 1) * S_loc, S)
        return S_loc, lo, hi, S_loc * (at + 1) > S


class TransformerLM(LanguageModel):
    """Families dense, moe (GQA or MLA), audio (frame embeds in) and vlm
    (patch + text)."""

    SPECS = PARAM_SPECS

    def __init__(self, cfg: ArchConfig, remat: str = "full",
                 device="cuda"):
        super().__init__(cfg, remat, device)
        if cfg.family not in ("dense", "moe", "audio", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not a TransformerLM")
        n_pre = cfg.moe.first_dense if cfg.moe else 0
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.moe is not None, device)
            for _ in range(cfg.n_layers - n_pre))
        self.final_norm = init_norm(cfg, cfg.d_model, device)
        self.pre_blocks = nn.ModuleList(Block(cfg, False, device)
                                        for _ in range(n_pre))
        for i, blk in enumerate(self.layers()):
            blk.layer = i       # the ``layer`` of its spans

    def layers(self) -> list[Block]:
        """Every block in the order the model runs them and the cache
        stacks them: the pre-blocks, then the stack."""
        return [*self.pre_blocks, *self.blocks]

    # ------------------------------------------------------------ embed
    def _embed(self, batch) -> torch.Tensor:
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            h = batch["frame_embeds"].to(cfg.compute_dtype)
        elif cfg.frontend == "vision_stub":
            text = embed_tokens(self.embed, batch["tokens"],
                                cfg.compute_dtype)
            patches = batch["patch_embeds"].to(cfg.compute_dtype)
            h = torch.cat([patches, text], dim=1)
        else:
            h = embed_tokens(self.embed, batch["tokens"], cfg.compute_dtype)
        return shd.seq_slice(h, 1, self._seq())

    # ------------------------------------------------------------ blocks
    def _block_fwd(self, blk: Block, h, positions, kv_out: bool = False):
        """(h, aux (0-d float32), kv).  ``h`` is the rank's block of the
        sequence where the stream is cut (``act_seq``): gathered once
        before attention, as the reference's hint re-gathers it."""
        cfg = self.cfg
        seq = self._seq()
        with obs.span("model.attn", device=h.device, layer=blk.layer):
            a_in = shd.all_gather(apply_norm(cfg, blk.ln1, h), 1,
                                  seq and seq.group)
            forward = attn.mla_forward if cfg.attention == "mla" \
                else attn.gqa_forward
            a_out, kv = forward(cfg, blk.attn, a_in, positions,
                                kv_out=kv_out)
            h = h + tp_combine(a_out, attn.head_split(cfg, blk.attn)[0],
                               seq)
        with obs.span("model.ffn", device=h.device, layer=blk.layer):
            f_out, aux = self._ffn(blk, apply_norm(cfg, blk.ln2, h), seq)
            h = h + f_out
        return h, aux, kv

    def _ffn(self, blk: Block, x, seq=None):
        """(out, aux) of the block's MLP or mixture of experts; ``seq``:
        ``x`` is the rank's block of a sequence cut over that group."""
        if hasattr(blk, "moe"):
            return moe_ffn(self.cfg, blk.moe, x)
        tp = shd.tp_group(self.cfg.d_ff, blk.mlp["w1"].shape[1])
        out = apply_mlp(self.cfg, blk.mlp,
                        shd.all_gather(x, 1, seq and seq.group))
        return tp_combine(out, tp, seq), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------ train
    def _train_block(self, blk: Block, h, positions):
        with gathered(blk):
            return self._block_fwd(blk, h, positions)[:2]

    def loss(self, batch):
        with gathered(self.embed, "tok"):
            h = self._embed(batch)
        seq = self._seq()
        positions = self._positions(h, 1 if seq is None else seq.size)
        aux0 = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk in self.pre_blocks:
            h, a = self._train_block(blk, h, positions)
            aux0 = aux0 + a
        block = _remat(self._train_block, self.remat)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk in self.blocks:
            h, a = block(blk, h, positions)
            aux = aux + a
        return self._objective(h, batch["labels"], aux + aux0)

    # ------------------------------------------------------------ serve
    def _cache_leaves(self) -> dict[str, tuple]:
        """Each cache leaf's shape past (L, B, S) and its dtype."""
        cfg = self.cfg
        if cfg.attention == "mla":
            m = cfg.mla
            return {"ckv": ((m.kv_lora_rank,), cfg.compute_dtype),
                    "krope": ((m.qk_rope_head_dim,), cfg.compute_dtype)}
        K, hd = cfg.n_kv_heads, cfg.head_dim
        if KV_CACHE_QUANT:
            return {"k": ((K, hd), torch.int8), "v": ((K, hd), torch.int8),
                    "k_scale": ((K,), torch.float32),
                    "v_scale": ((K,), torch.float32)}
        return {"k": ((K, hd), cfg.compute_dtype),
                "v": ((K, hd), cfg.compute_dtype)}

    def abstract_cache(self, batch: int, max_seq: int):
        """The cache as meta tensors, and its logical-axis specs."""
        L = self.cfg.n_layers
        bdp = None if batch == 1 else "dp"
        sp = "all" if batch == 1 else "sp"
        cache, specs = {}, {}
        for k, (tail, dtype) in self._cache_leaves().items():
            cache[k] = torch.empty((L, batch, max_seq, *tail), dtype=dtype,
                                   device="meta")
            specs[k] = (None, bdp, sp, *([None] * len(tail)))
        cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
        specs["pos"] = ()
        return cache, specs

    def prefill(self, batch, max_seq: int | None = None):
        """Process a full prompt; returns (last-token logits, cache), the
        cache ``max_seq`` positions long (default: the prompt's), zeros
        past the prompt.  Under active rules ``batch`` is the whole
        batch; the cache is the rank's block and the logits whole
        (``_serve_groups``)."""
        cfg = self.cfg
        B = next(iter(batch.values())).shape[0]
        dp, sp = self._serve_groups(B)
        batch = self._rank_batch(batch)
        with gathered(self.embed, "tok"):
            h = self._embed(batch)
        seq = self._seq()
        positions = self._positions(h, 1 if seq is None else seq.size)
        S = positions.shape[1]
        S_loc, lo, hi, past = self._seq_block(S, max_seq, sp)
        mla = cfg.attention == "mla"
        if mla:
            m = cfg.mla
            tails = ((m.kv_lora_rank,), (m.qk_rope_head_dim,))
        else:
            tails = ((cfg.n_kv_heads, cfg.head_dim),) * 2
        alloc = torch.zeros if past else torch.empty
        c1, c2 = (alloc((cfg.n_layers, h.shape[0], S_loc, *t),
                        dtype=cfg.compute_dtype, device=h.device)
                  for t in tails)
        for i, blk in enumerate(self.layers()):
            with gathered(blk):
                h, _, (a, b) = self._block_fwd(blk, h, positions,
                                               kv_out=True)
            if hi > lo:
                c1[i, :, :hi - lo], c2[i, :, :hi - lo] = a[:, lo:hi], \
                    b[:, lo:hi]
        with obs.span("model.head", device=h.device, layer=cfg.n_layers):
            logits = self._serve_logits(h, dp)
        if mla:
            cache = {"ckv": c1, "krope": c2}
        elif KV_CACHE_QUANT:
            kq, k_scale = attn.quantize_kv(c1)
            vq, v_scale = attn.quantize_kv(c2)
            # positions past the prompt hold zeros, scales included, as
            # the serve engine grows a prompt-long cache
            k_scale[:, :, max(hi - lo, 0):] = 0
            v_scale[:, :, max(hi - lo, 0):] = 0
            cache = {"k": kq, "v": vq, "k_scale": k_scale,
                     "v_scale": v_scale}
        else:
            cache = {"k": c1, "v": c2}
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=h.device)
        return logits, cache

    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """tokens: (B, 1) int32.  Returns (logits (B, V), cache), the
        cache's entries written in place.  Under active rules ``tokens``
        are the whole batch's and ``cache`` the rank's block."""
        cfg = self.cfg
        pos = cache["pos"]
        quant = KV_CACHE_QUANT and cfg.attention == "gqa"
        if quant and len(self.pre_blocks):
            raise AssertionError("q8 decode: no pre-block GQA archs")
        dp, sp = self._serve_groups(tokens.shape[0])
        tokens = self._rank_batch({"tokens": tokens})["tokens"]
        with gathered(self.embed, "tok"):
            h = embed_tokens(self.embed, tokens, cfg.compute_dtype)
        for i, blk in enumerate(self.layers()):
            with gathered(blk):
                h = self._decode_block(blk, h, pos, cache, i, quant, sp)
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        with obs.span("model.head", layer=cfg.n_layers):
            return self._serve_logits(h, dp), new_cache

    def _decode_block(self, blk: Block, h, pos, cache: dict, i: int,
                      quant: bool, sp):
        cfg = self.cfg
        with obs.span("model.attn", layer=blk.layer):
            a_in = apply_norm(cfg, blk.ln1, h)
            if cfg.attention == "mla":
                a_out = attn.mla_decode(cfg, blk.attn, a_in, pos,
                                        cache["ckv"][i], cache["krope"][i],
                                        sp=sp)[0]
            elif quant:
                a_out = attn.gqa_decode_q8(
                    cfg, blk.attn, a_in, pos, cache["k"][i], cache["v"][i],
                    cache["k_scale"][i], cache["v_scale"][i], sp=sp)[0]
            else:
                a_out = attn.gqa_decode(cfg, blk.attn, a_in, pos,
                                        cache["k"][i], cache["v"][i],
                                        sp=sp)[0]
            h = h + a_out
        with obs.span("model.ffn", layer=blk.layer):
            return h + self._ffn(blk, apply_norm(cfg, blk.ln2, h))[0]


# --------------------------------------------------------------------------
# init, shared by every model class
# --------------------------------------------------------------------------


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator,
                 constants: dict[str, float] | None = None) -> None:
    """Fill every parameter of ``model``: norm scales 1, biases 0 and
    the leaves named in ``constants`` their value; every other weight
    normal * d_in^-0.5 drawn from ``generator`` (``dense_init_``, d_in
    by ``fan_in``)."""
    consts = {"scale": 1.0, "bias": 0.0, **(constants or {})}
    for name, p in model.named_parameters():
        part, leaf = name.split(".")[-2:]
        if leaf in consts:
            p.fill_(consts[leaf])
        else:
            dense_init_(p, fan_in(part, leaf, p.shape), generator)


# --------------------------------------------------------------------------
# the reference's params tree
# --------------------------------------------------------------------------
#
# A parameter's name in the module says where it sits in the reference's
# tree.  The integers right after the top-level name index the leaf's
# stacked leading axes: ``blocks.3.attn.wq`` is layer 3 of
# ``["blocks"]["attn"]["wq"]`` (L stacked), zamba's ``mamba.2.4.ln.scale``
# entry (2, 4) of ``["mamba"]["ln"]["scale"]`` (G and K stacked).  The
# moe family's ``pre_blocks`` are the exception: the reference keeps
# them as a list of per-layer trees, so ``pre_blocks.0.attn.wq`` is
# ``["pre_blocks"][0]["attn"]["wq"]``, unstacked.

_LISTS = ("pre_blocks",)


def reference_path(name: str) -> tuple[tuple, tuple[int, ...]]:
    """A parameter's name -> (its path in the reference's tree, its
    index on that leaf's stacked axes; () for an unstacked leaf)."""
    top, *rest = name.split(".")
    if top in _LISTS:
        return (top, int(rest[0]), *rest[1:]), ()
    index = []
    while rest and rest[0].isdigit():
        index.append(int(rest.pop(0)))
    return (top, *rest), tuple(index)


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _nest(items: dict[tuple, object]) -> dict:
    """{path: leaf} -> the nested tree, ``pre_blocks`` as a list."""
    tree: dict = {}
    for path, leaf in items.items():
        _put(tree, path, leaf)
    for top in _LISTS:
        if top in tree:
            tree[top] = [tree[top][i] for i in range(len(tree[top]))]
    return tree


def _stacks(names) -> dict[tuple, tuple[int, ...]]:
    """The stacked axes' sizes of each path that ``names`` stack."""
    sizes: dict[tuple, tuple[int, ...]] = {}
    for name in names:
        path, index = reference_path(name)
        if index:
            size = sizes.get(path, (0,) * len(index))
            sizes[path] = tuple(max(n, i + 1) for n, i in zip(size, index))
    return sizes


def reference_abstract(model: nn.Module, specs_of: dict) -> tuple:
    """(params as meta tensors, logical-axis specs) of ``model`` in the
    reference's tree layout; ``specs_of`` maps (part, leaf) to the
    leaf's spec, each stacked axis adding a leading None.  A sharded
    parameter counts whole (``sharding.mark_sharded``)."""
    params = dict(model.named_parameters())
    sizes = _stacks(params)
    shapes, specs = {}, {}
    for name, p in params.items():
        path, index = reference_path(name)
        if path in shapes:
            continue
        lead = sizes.get(path, ())
        shapes[path] = torch.empty((*lead, *getattr(p, "fsdp_shape",
                                                     p.shape)),
                                   dtype=p.dtype, device="meta")
        specs[path] = (None,) * len(lead) + specs_of[path[-2:]]
    return _nest(shapes), _nest(specs)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16, by its bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaf(a) -> torch.Tensor:
    """A reference tree's leaf as a tensor: tensors as they are (a
    restored checkpoint's), anything else through numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    return _from_numpy(np.asarray(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:         # numpy has no bf16: exact in f32
        t = t.float()
    return t.numpy().copy()


def _reference_leaves(model: nn.Module, tree) -> dict[str, torch.Tensor]:
    """Each parameter's slice of the reference's ``tree`` (tensors or
    numpy-convertible leaves), keyed by parameter name; a stacked leaf
    must have the model's count on each stacked axis."""
    names = [n for n, _ in model.named_parameters()]
    sizes = _stacks(names)
    for top in _LISTS:
        n = len({reference_path(name)[0][1] for name in names
                 if name.startswith(f"{top}.")})
        if len(tree.get(top, [])) != n:
            raise ValueError(f"{top}: {len(tree.get(top, []))} layers, the "
                             f"model has {n}")
    whole: dict[tuple, torch.Tensor] = {}
    out = {}
    for name in names:
        path, index = reference_path(name)
        if path not in whole:
            whole[path] = t = _leaf(_get(tree, path))
            lead = sizes.get(path, ())
            if tuple(t.shape[:len(lead)]) != lead:
                raise ValueError(f"{'/'.join(path)}: stacked "
                                 f"{tuple(t.shape[:len(lead)])}, the model "
                                 f"has {lead}")
        out[name] = whole[path][index]
    return out


@torch.no_grad()
def params_from_reference(model: nn.Module, tree) -> nn.Module:
    """Fill ``model`` from the reference's params tree (tensors or
    numpy-convertible leaves, in the layout ``reference_path`` reads),
    each leaf cast to its parameter's dtype on its device."""
    leaves = _reference_leaves(model, tree)
    for name, p in model.named_parameters():
        p.copy_(leaves[name])
    return model


def params_to_reference(model: nn.Module) -> dict:
    """The reference's params tree of ``model``: numpy leaves (bfloat16
    parameters as float32, which holds them exactly), stacked leaves
    stacked, ``pre_blocks`` a list."""
    tree = _reference_tree(dict(model.named_parameters()))
    return _map(tree, _to_numpy)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


# --------------------------------------------------------------------------
# the reference's train state: {"params", "opt": {"m", "v", "step"}}
# --------------------------------------------------------------------------


def _reference_tree(leaves: dict[str, torch.Tensor]) -> dict:
    """Leaves keyed by parameter name -> the reference's nested tree of
    fresh host tensors in their dtypes: each stacked leaf copied entry
    by entry into one host tensor (so the card holds no second copy),
    ``pre_blocks`` a list.  A sharded leaf (``sharding.is_sharded``)
    raises ``ValueError``: its block is not the leaf the name says."""
    _refuse_sharded(leaves.items())
    sizes = _stacks(leaves)
    items: dict[tuple, torch.Tensor] = {}
    for name, t in leaves.items():
        path, index = reference_path(name)
        if not index:
            items[path] = t.detach().to("cpu", copy=True)
            continue
        if path not in items:
            items[path] = torch.empty((*sizes[path], *t.shape),
                                      dtype=t.dtype)
        items[path][index].copy_(t.detach())
    return _nest(items)


def _refuse_sharded(named) -> None:
    for name, t in named:
        if is_sharded(t):
            raise ValueError(
                f"{name} is this rank's block of a sharded parameter, not "
                "the leaf its name says: gather it "
                "(sharded_state_to_reference)")


def train_state_to_reference(state: dict) -> dict:
    """The reference's train-state tree of a port train state
    (``steps.init_train_state``): params, ``m`` and ``v`` in the
    reference's layout, and ``step``; fresh host tensors in the state's
    dtypes (bf16 stays bf16), the layout a train checkpoint keeps.  A
    sharded state (``steps.shard_train_state``) raises ``ValueError``
    (``sharded_state_to_reference`` gathers it)."""
    return sharded_state_to_reference(state, None, writer=True)


def train_state_from_reference(model: nn.Module, tree) -> dict:
    """A port train state from the reference's tree (numpy-convertible
    or tensor leaves): the params are copied into ``model``, which the
    state then holds; ``m``, ``v`` (their stored dtype) and ``step``
    (0-d int32) land on the model's device.  A model whose parameters
    are sharded raises ``ValueError`` (``sharded_state_from_reference``
    fills its blocks)."""
    _refuse_sharded(model.named_parameters())
    params_from_reference(model, tree["params"])
    params = dict(model.named_parameters())
    dev = model.device

    def moments(sub) -> dict[str, torch.Tensor]:
        return {name: t.to(dev, copy=True)
                for name, t in _reference_leaves(model, sub).items()}

    opt = tree["opt"]
    step = _leaf(opt["step"]).to(device=dev, dtype=torch.int32)
    return {"params": params,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": step.reshape(())}}


# --------------------------------------------------------------------------
# a sharded train state and the reference's tree, leaf by leaf
# --------------------------------------------------------------------------


def _state_parts(state: dict):
    """(part, the state's tree of it) of params, ``m`` and ``v``."""
    opt = state["opt"]
    return (("params", state["params"]), ("m", opt["m"]), ("v", opt["v"]))


@torch.no_grad()
def sharded_state_to_reference(state: dict, rules, writer: bool):
    """The reference's train-state tree of a sharded state
    (``steps.shard_train_state``), whole, as fresh host tensors on the
    ``writer`` rank, None on the others.  Every rank calls it together:
    each parameter's and moment's block is gathered whole on every rank
    (``sharding.gather_whole``) one at a time, in the parameters' order,
    on the caller's thread; the writer copies it into its host leaf and
    every rank drops it, so a rank holds its blocks and one whole
    parameter at a time.  With ``rules`` None the state must not be
    sharded, and is copied (``train_state_to_reference``)."""
    params = state["params"]
    if rules is None:
        _refuse_sharded(params.items())
    sizes = _stacks(params)
    items: dict[tuple, torch.Tensor] = {}
    for part, tree in _state_parts(state):
        for name, t in tree.items():
            p = params[name]
            whole = t.detach()
            if is_sharded(p):
                spec = shd.fitted(rules, p.fsdp_spec, p.fsdp_shape)
                whole = shd.gather_whole(whole, spec, rules)
            if not writer:
                continue
            path, index = reference_path(name)
            key = (part, *path)
            if not index:
                items[key] = whole.to("cpu", copy=True)
                continue
            if key not in items:
                items[key] = torch.empty((*sizes[path], *whole.shape),
                                         dtype=whole.dtype)
            items[key][index].copy_(whole)
            del whole
    if not writer:
        return None
    tree = _nest(items)
    return {"params": tree["params"],
            "opt": {"m": tree["m"], "v": tree["v"],
                    "step": state["opt"]["step"].detach().to("cpu",
                                                             copy=True)}}


@torch.no_grad()
def sharded_state_from_reference(model: nn.Module, state: dict, tree,
                                 rules, writer: int = 0) -> dict:
    """Fill ``state``, a sharded state of ``model`` (its values are
    overwritten), from the reference's whole tree, which rank ``writer``
    of the default process group holds (the others pass None): for each
    parameter and moment in the parameters' order the writer cuts every
    rank's block of its fitted spec from the whole host leaf and scatters
    them (bytes, on the host), each rank copying its own into its block;
    the step is broadcast.  Every rank calls it together, and every rank
    ends with the blocks ``shard_train_state`` gives of that tree."""
    import torch.distributed as dist

    params = state["params"]
    shape = tuple(shd.mesh_sizes(rules.mesh).values())
    n = dist.get_world_size()
    if n != int(np.prod(shape)):
        raise ValueError(f"{n} ranks for a mesh of {shape}")
    me = dist.get_rank()
    leaves = None
    if me == writer:
        leaves = {part: _reference_leaves(model, sub) for part, sub in (
            ("params", tree["params"]), ("m", tree["opt"]["m"]),
            ("v", tree["opt"]["v"]))}
    for part, sub in _state_parts(state):
        for name, block in sub.items():
            p = params[name]
            cut = rules.named(shd.fitted(rules, p.fsdp_spec, p.fsdp_shape)) \
                if is_sharded(p) else None
            mine = torch.empty(block.numel() * block.element_size(),
                               dtype=torch.uint8)
            parts = None
            if me == writer:
                whole = leaves[part][name].to(block.dtype)
                parts = [_as_bytes(whole if cut is None else shd.local_shard(
                    whole, cut, coord=np.unravel_index(r, shape)))
                    for r in range(n)]
            dist.scatter(mine, parts, src=writer)
            block.copy_(mine.view(block.dtype).view(block.shape))
    step = torch.zeros(1, dtype=torch.int64)
    if me == writer:
        step[0] = int(_leaf(tree["opt"]["step"]))
    dist.broadcast(step, src=writer)
    state["opt"]["step"].fill_(int(step[0]))
    return state


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
