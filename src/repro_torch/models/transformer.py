"""Model assembly: the decoder stack of the dense, audio and vlm families.

The counterpart of ``repro.models.transformer.TransformerLM`` for
``attention="gqa"`` without experts:

  model = build_model(cfg, device=...)       # repro_torch.models.archs
  model.init(generator)                      # seeded, in place
  loss, metrics = model.loss(batch)          # forward + chunked CE
  logits, cache = model.prefill(batch)       # build the decode cache
  logits, cache = model.decode_step(tokens, cache)
  cache, cache_specs = model.abstract_cache(B, S)   # meta tensors + specs

Layers are ``Block`` modules in an ``nn.ModuleList``, run one after the
other (the reference scans one stacked block).  The decode cache is the
reference's: a dict of stacked ``(L, B, S, K, hd)`` tensors ``k`` and
``v`` (int8 plus ``(L, B, S, K)`` float32 ``k_scale``/``v_scale`` when
``KV_CACHE_QUANT``) and a 0-d int32 ``pos``, so its KV pages have the
reference's keys and bytes.  ``decode_step`` writes the new token's K
and V into the cache it is given, in place, and returns it with
``pos + 1``.

``params_from_reference`` / ``params_to_reference`` move weights from
and to the reference's params tree (numpy leaves, ``blocks`` stacked on
a leading L axis).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import hint
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
)

# int8 KV cache for GQA decode (per-(token, kv-head) symmetric scales)
KV_CACHE_QUANT = False


class Block(nn.Module):
    """One decoder layer: pre-norm attention and MLP, residual adds."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg, cfg.d_model, device)
        self.ln2 = init_norm(cfg, cfg.d_model, device)
        self.attn = attn.init_attention(cfg, device)
        self.mlp = init_mlp(cfg, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            device)


class TransformerLM(nn.Module):
    """Families dense, audio (frame embeds in) and vlm (patch + text)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: mixture-of-experts layers (models/moe.py) are "
                "not ported yet (ROADMAP 'Still to port': MoE)")
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: attention={cfg.attention!r} is not ported yet "
                "(ROADMAP 'Still to port': MLA)")
        if cfg.family not in ("dense", "audio", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not a TransformerLM")
        self.cfg = cfg
        self.embed = init_embed(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Norm scales 1 and biases 0; every weight normal * d_in^-0.5,
        drawn in float32 from ``generator`` (on the model's device) and
        cast, d_in being the weight's contraction width."""
        cfg = self.cfg
        fan_in = {"tok": cfg.d_model, "wo": cfg.n_heads * cfg.head_dim}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                dense_init_(p, fan_in.get(leaf, p.shape[0]), generator)
        return self

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
        return hint(h, "dp", "act_seq", None)

    # ------------------------------------------------------------ blocks
    def _block_fwd(self, blk: Block, h, positions, kv_out: bool = False):
        cfg = self.cfg
        a_in = hint(apply_norm(cfg, blk.ln1, h), "dp", None, None)
        a_out, kv = attn.gqa_forward(cfg, blk.attn, a_in, positions,
                                     kv_out=kv_out)
        h = hint(h + a_out, "dp", "act_seq", None)
        f_out = apply_mlp(cfg, blk.mlp, apply_norm(cfg, blk.ln2, h))
        return hint(h + f_out, "dp", "act_seq", None), kv

    def _positions(self, h: torch.Tensor) -> torch.Tensor:
        B, S = h.shape[0], h.shape[1]
        return torch.arange(S, dtype=torch.int32,
                            device=h.device).expand(B, S)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Last-position logits in float32 against a float32 head."""
        h = apply_norm(self.cfg, self.final_norm, h)
        return h[:, -1].float() @ self.embed["head"].float()

    # ------------------------------------------------------------ train
    def loss(self, batch):
        h = self._embed(batch)
        positions = self._positions(h)
        for blk in self.blocks:
            h, _ = self._block_fwd(blk, h, positions)
        h = apply_norm(self.cfg, self.final_norm, h)
        loss, metrics = chunked_softmax_xent(h, self.embed["head"],
                                             batch["labels"])
        metrics["aux_loss"] = torch.zeros((), dtype=torch.float32,
                                          device=h.device)
        return loss + metrics["aux_loss"], metrics

    # ------------------------------------------------------------ serve
    def abstract_cache(self, batch: int, max_seq: int):
        """The cache as meta tensors, and its logical-axis specs."""
        cfg = self.cfg
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        bdp = None if batch == 1 else "dp"
        sp = "all" if batch == 1 else "sp"

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if KV_CACHE_QUANT:
            kv_dt, kv_shape = torch.int8, (L, batch, max_seq, K, hd)
            cache = {"k": meta(kv_shape, kv_dt), "v": meta(kv_shape, kv_dt),
                     "k_scale": meta(kv_shape[:-1], torch.float32),
                     "v_scale": meta(kv_shape[:-1], torch.float32)}
            specs = {"k": (None, bdp, sp, None, None),
                     "v": (None, bdp, sp, None, None),
                     "k_scale": (None, bdp, sp, None),
                     "v_scale": (None, bdp, sp, None)}
        else:
            kv_shape = (L, batch, max_seq, K, hd)
            cache = {"k": meta(kv_shape, cfg.compute_dtype),
                     "v": meta(kv_shape, cfg.compute_dtype)}
            specs = {"k": (None, bdp, sp, None, None),
                     "v": (None, bdp, sp, None, None)}
        cache["pos"] = meta((), torch.int32)
        specs["pos"] = ()
        return cache, specs

    def init_cache(self, batch: int, max_seq: int) -> dict:
        shapes, _ = self.abstract_cache(batch, max_seq)
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in shapes.items()}

    def prefill(self, batch):
        """Process a full prompt; returns (last-token logits, cache)."""
        cfg = self.cfg
        h = self._embed(batch)
        B, S = h.shape[0], h.shape[1]
        positions = self._positions(h)
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=cfg.compute_dtype, device=h.device)
        vs = torch.empty_like(ks)
        for i, blk in enumerate(self.blocks):
            h, (k, v) = self._block_fwd(blk, h, positions, kv_out=True)
            ks[i], vs[i] = k, v
        logits = self._logits(h)
        if KV_CACHE_QUANT:
            kq, k_scale = attn.quantize_kv(ks)
            vq, v_scale = attn.quantize_kv(vs)
            cache = {"k": kq, "v": vq, "k_scale": k_scale,
                     "v_scale": v_scale}
        else:
            cache = {"k": ks, "v": vs}
        cache = {k: hint(v, None, "dp" if B > 1 else None,
                         "sp" if B > 1 else "all", *([None] * (v.ndim - 3)))
                 for k, v in cache.items()}
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=h.device)
        return logits, cache

    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """tokens: (B, 1) int32.  Returns (logits (B, V), cache), the
        cache's K and V written in place."""
        cfg = self.cfg
        pos = cache["pos"]
        h = embed_tokens(self.embed, tokens, cfg.compute_dtype)
        for i, blk in enumerate(self.blocks):
            a_in = apply_norm(cfg, blk.ln1, h)
            if KV_CACHE_QUANT:
                a_out = attn.gqa_decode_q8(
                    cfg, blk.attn, a_in, pos, cache["k"][i], cache["v"][i],
                    cache["k_scale"][i], cache["v_scale"][i])[0]
            else:
                a_out = attn.gqa_decode(cfg, blk.attn, a_in, pos,
                                        cache["k"][i], cache["v"][i])[0]
            h = h + a_out
            h = h + apply_mlp(cfg, blk.mlp, apply_norm(cfg, blk.ln2, h))
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        return self._logits(h), new_cache


# --------------------------------------------------------------------------
# the reference's params tree
# --------------------------------------------------------------------------


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16, by its bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:         # numpy has no bf16: exact in f32
        t = t.float()
    return t.numpy().copy()


def _top_items(module: TransformerLM):
    """(path in the reference's tree, parameter) of the embedding and
    the final norm."""
    top = [(("embed", k), p) for k, p in module.embed.items()]
    top += [(("final_norm", k), p) for k, p in module.final_norm.items()]
    return top


def _block_items(blk: Block):
    """(path under the reference's ``blocks``, parameter) of one block."""
    for part in ("ln1", "ln2", "attn", "mlp"):
        for k, p in getattr(blk, part).items():
            yield (part, k), p


@torch.no_grad()
def params_from_reference(model: TransformerLM, tree) -> TransformerLM:
    """Fill ``model`` from the reference's params tree (numpy-convertible
    leaves; ``blocks`` stacked on a leading L axis), each leaf cast to
    its parameter's dtype on its device."""
    for path, p in _top_items(model):
        p.copy_(_from_numpy(np.asarray(tree[path[0]][path[1]])))
    blocks = tree["blocks"]
    for (part, k), _ in _block_items(model.blocks[0]):
        stacked = _from_numpy(np.asarray(blocks[part][k]))
        if stacked.shape[0] != len(model.blocks):
            raise ValueError(f"blocks/{part}/{k}: {stacked.shape[0]} "
                             f"layers, the model has {len(model.blocks)}")
        for i, blk in enumerate(model.blocks):
            getattr(blk, part)[k].copy_(stacked[i])
    return model


def params_to_reference(model: TransformerLM) -> dict:
    """The reference's params tree of ``model``: numpy leaves, ``blocks``
    stacked on a leading L axis (bfloat16 parameters as float32, which
    holds them exactly)."""
    tree: dict = {}
    for (top, k), p in _top_items(model):
        tree.setdefault(top, {})[k] = _to_numpy(p)
    blocks: dict = {}
    for (part, k), _ in _block_items(model.blocks[0]):
        blocks.setdefault(part, {})[k] = np.stack(
            [_to_numpy(getattr(blk, part)[k]) for blk in model.blocks])
    tree["blocks"] = blocks
    return tree
