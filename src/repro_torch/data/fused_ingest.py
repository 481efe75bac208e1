"""Fused ingest: storage-side compression decoded on the card.

The paper's ``compress`` offload on the input path: objects store
tokens planar-bitpacked; the loader ships the packed words to the card,
and the unpack (the ``bitunpack`` kernel) and the label derivation (a
row shift the storage layer knows from the dataset's schema) run there,
in front of the train step.

Input-path bytes per token: 8 (tokens + labels int32) -> bits/8 (about
2.1 for a 17-bit vocabulary) for the host -> device copy of a batch.
uint32 words are carried as int32 tensors of the same bits.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.format import bitpack_encode, bitpack_width
from repro_torch.core.pushdown_torch import unpack_bitpacked
from repro_torch.kernels import ops


def pack_batch(tokens: np.ndarray, bits: int) -> np.ndarray:
    """(B, S) int32 -> (B, S//32, bits) uint32 planar words (host side —
    what the OSD already stores; see objclass.select_packed)."""
    B, S = tokens.shape
    if S % 32:
        raise ValueError("S must be a multiple of 32")
    return bitpack_encode(tokens.ravel(), bits).reshape(B, S // 32, bits)


def unpack_tokens(packed: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
    """(B, G, bits) int32 words -> (B, G*32) int32 tokens on their device.

    ``use_kernel`` goes through ``ops.bitunpack_tokens`` (the reference's
    ``use_pallas`` route, which needs G % 4 == 0), otherwise through
    ``pushdown_torch.unpack_bitpacked``.  On the card both run the
    ``bitunpack`` kernel; the values are bit-identical."""
    B, G, bits = packed.shape
    if use_kernel:
        if G % 4:
            raise ValueError(f"use_kernel needs G % 4 == 0 "
                             f"(128-value rows), got G={G}")
        return ops.bitunpack_tokens(packed, bits=bits)
    return unpack_bitpacked(packed, bits)


def derive_labels(tokens: torch.Tensor) -> torch.Tensor:
    """labels[t] = tokens[t+1]; last position masked with -1."""
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return labels


def fused_batch(packed: torch.Tensor) -> dict[str, torch.Tensor]:
    tokens = unpack_tokens(packed)
    return {"tokens": tokens, "labels": derive_labels(tokens)}


def _words(batch: dict) -> np.ndarray:
    return np.ascontiguousarray(batch["tokens_packed"]).view(np.int32)


def device_stream(loader, *, lookahead: int = 1,
                  device: str | torch.device = "cuda:0"):
    """Iterate a packed loader as packed words on ``device``, with
    ``lookahead`` batches' host -> device copies in flight.

    On a CUDA device each batch is staged in a pinned host tensor and
    copied with ``non_blocking=True`` on a side stream; the consumer's
    stream waits on the copy's event before it gets the batch, so the
    copy of the next batch overlaps the caller's work on this one.  On
    ``device="cpu"`` it is a plain iterator.  Yields (B, G, bits) int32
    tensors, the input of :func:`fused_batch`."""
    dev = torch.device(device)
    if dev.type == "cpu":
        for batch in loader:
            yield torch.from_numpy(_words(batch))
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device_stream: no CUDA device is available")
    side = torch.cuda.Stream(dev)
    q: deque = deque()
    it = iter(loader)

    def pull() -> None:
        try:
            words = _words(next(it))
        except StopIteration:
            return
        host = torch.from_numpy(words).pin_memory()
        with torch.cuda.stream(side):
            on_dev = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        q.append((on_dev, done))

    for _ in range(max(lookahead, 0) + 1):
        pull()
    while q:
        words, done = q.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        # allocated on the side stream, used on the consumer's: keep the
        # allocator from reusing it before the consumer's work is done
        words.record_stream(consumer)
        pull()
        yield words


def make_fused_train_step(base_train_step):
    """Wrap a (state, batch) -> (state, metrics) step to take packed
    words: the unpack and the labels run on the words' device first
    (the span ``train.unpack``)."""

    def fused_step(state, packed):
        with obs.span("train.unpack"):
            batch = fused_batch(packed)
        return base_train_step(state, batch)

    return fused_step


def packed_input_spec(global_batch: int, seq_len: int, vocab: int
                      ) -> torch.Tensor:
    """The packed batch as a meta tensor (the dry run's input stand-in):
    (B, S // 32, bits) int32, the reference's uint32 words."""
    bits = bitpack_width(vocab - 1)
    return torch.empty((global_batch, seq_len // 32, bits),
                       dtype=torch.int32, device="meta")
