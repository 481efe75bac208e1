"""Input specifications per (architecture x shape) cell.

The counterpart of ``repro.models.inputs``.  ``*_input_specs`` return
meta-device tensors (shape and dtype, no storage) for every model input
with a matching tree of logical-axis specs (one entry per dimension,
resolved by ``repro_torch.distributed.sharding``).  ``make_batch``
materializes concrete random inputs at smoke scale: the same numpy
draws as the reference's, so one seed gives both packages equal values.

Modality frontends are stubs: audio (musicgen) receives precomputed
frame embeddings; vlm (pixtral) receives precomputed patch embeddings
occupying the first ``n_frontend_tokens`` positions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """Inputs for train_step / prefill_step: the full-sequence batch."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_stub":
        batch = {"frame_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                 "labels": _meta((B, S), torch.int32)}
        specs = {"frame_embeds": ("dp", None, None), "labels": ("dp", None)}
    elif cfg.frontend == "vision_stub":
        Pn = cfg.n_frontend_tokens
        if not S > Pn:
            raise ValueError(f"sequence {S} must exceed the {Pn} patches")
        batch = {"patch_embeds": _meta((B, Pn, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((B, S - Pn), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        specs = {"patch_embeds": ("dp", None, None),
                 "tokens": ("dp", None), "labels": ("dp", None)}
    else:
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        specs = {"tokens": ("dp", None), "labels": ("dp", None)}
    if shape.global_batch == 1:  # long-context: can't shard batch
        specs = {k: (None,) + s[1:] for k, s in specs.items()}
    return batch, specs


def shard_batch(batch: dict, rules, microbatches: int = 1) -> dict:
    """This rank's block of a whole train batch under ``rules``, by the
    reference's batch specs (``train_input_specs``): every leaf
    (``tokens``, ``labels``, ``patch_embeds``, ``frame_embeds``) cut on
    dimension 0 over ``"dp"``, none when the global batch is 1.  With
    ``microbatches`` > 1 each of the reference's micro-batches (the
    batch's consecutive rows in ``microbatches`` equal parts) is cut on
    its own, so the rank's block, split the same way, gives the rank's
    part of each."""
    from repro_torch.distributed import sharding as shd

    out = {}
    for k, x in batch.items():
        B = x.shape[0]
        if B == 1:
            out[k] = x
            continue
        if B % microbatches:
            raise ValueError(f"{k}: batch {B} in {microbatches} "
                             "micro-batches")
        parts = x.reshape(microbatches, B // microbatches, *x.shape[1:])
        spec = (None, "dp") + (None,) * (x.ndim - 1)
        out[k] = shd.local_shard(parts, rules.sharding(*spec)).reshape(
            -1, *x.shape[1:])
    return out


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """Inputs for serve_step: one new token per sequence."""
    B = shape.global_batch
    spec = ("dp", None) if B > 1 else (None, None)
    return _meta((B, 1), torch.int32), spec


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
               device="cuda") -> dict:
    """Concrete random batch at smoke scale, on ``device``."""
    rng = np.random.default_rng(seed)

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    if cfg.frontend == "audio_stub":
        return {
            "frame_embeds": tensor(
                rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
                * 0.02, cfg.compute_dtype),
            "labels": tensor(
                rng.integers(0, cfg.vocab_size, (batch, seq)), torch.int32),
        }
    if cfg.frontend == "vision_stub":
        Pn = cfg.n_frontend_tokens
        labels = rng.integers(0, cfg.vocab_size, (batch, seq))
        labels[:, :Pn] = -1  # no loss on patch positions
        return {
            "patch_embeds": tensor(
                rng.normal(size=(batch, Pn, cfg.d_model)).astype(np.float32)
                * 0.02, cfg.compute_dtype),
            "tokens": tensor(
                rng.integers(0, cfg.vocab_size, (batch, seq - Pn)),
                torch.int32),
            "labels": tensor(labels, torch.int32),
        }
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq))
    return {"tokens": tensor(tokens, torch.int32),
            "labels": tensor(np.roll(tokens, -1, axis=1), torch.int32)}
