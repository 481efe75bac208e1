"""Batched serving engine: prefill -> decode loop over fixed batch slots.

The counterpart of ``repro.serve.engine``.  Requests are packed into one
prefill batch, left-padded with token 0 to the longest prompt (no pad
mask: pad positions are attended and positions start at the pad, as in
the reference), then decode runs lockstep for all slots with per-slot
stop handling, greedy.  Prefill and decode run eagerly on the model's
device under ``torch.inference_mode()``.

Session state (the KV cache) can be parked to / revived from the object
store between turns (``park_session`` / ``resume_session``) as KV pages
(``serve.kvcache``), keyed as the reference keys them, so a session
parked by either package resumes in the other.  Per-request analytics
scans go through one shared :class:`~repro_torch.core.session.
ScanSession` (``attach_analytics`` / ``analytics``): identical
concurrent scans single-flight into one OSD round trip.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch import obs, pytree
from repro_torch.core.session import ScanSession
from repro_torch.core.store import ObjectStore
from repro_torch.serve import kvcache, steps

# cache leaves with a sequence axis (axis 2 of (L, B, S, ...)), the int8
# cache's scales among them (the reference grows and tags neither, so its
# int8 cache cannot decode through its engine); others, such as ``pos``,
# are parked whole
_SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "ckv", "krope")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray          # (<=max_new,) int32
    steps: int


class ServeEngine:
    def __init__(self, model, *, max_seq: int = 512,
                 store: ObjectStore | None = None):
        self.model = model
        self.max_seq = max_seq
        self.store = store
        # hot-data serve plane: the analytics front-end for per-request
        # feature/context scans (attach_analytics)
        self.analytics_session: ScanSession | None = None
        self._prefill = steps.make_prefill_step(model)
        self._decode = steps.make_decode_step(model)
        self._batches = itertools.count()

    # ------------------------------------------------------------ data
    def attach_analytics(self, vol, *,
                         window_s: float = 0.0) -> ScanSession:
        """Attach the analytics front-end: per-request scans issued via
        ``analytics`` dedup through one shared :class:`ScanSession`
        (single-flight + column coalescing) over ``vol``."""
        self.analytics_session = ScanSession(vol, window_s=window_s)
        return self.analytics_session

    def analytics(self, scan) -> tuple[Any, dict]:
        """Run one per-request analytics scan through the serve plane,
        or directly when no session is attached."""
        if self.analytics_session is None:
            return scan.execute()
        return self.analytics_session.execute(scan)

    # ------------------------------------------------------------ batch
    @torch.inference_mode()
    def generate(self, reqs: list[Request]) -> list[Completion]:
        """Complete ``reqs`` together.  The call is the span
        ``serve.generate`` (``repro_torch.obs``) and every span of it
        carries its ``batch`` id: ``serve.prefill``, ``serve.pad_cache``,
        the instant ``serve.first_token`` once the first token is on the
        host, and one ``serve.decode`` a step, holding the step's launch
        (``serve.decode.launch``, inside the decode step), the wait for
        its tokens (``serve.token_sync``) and the per-slot bookkeeping
        (``serve.bookkeeping``)."""
        if not reqs:
            return []
        dev = self.model.device
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        batch = next(self._batches)
        with obs.span("serve.generate", batch=batch, requests=B, padded=S):
            prompts = np.zeros((B, S), np.int32)
            for i, r in enumerate(reqs):
                prompts[i, S - len(r.prompt):] = r.prompt  # left-pad
            with obs.span("serve.prefill", device=dev, batch=batch):
                logits, cache = self._prefill(
                    {"tokens": torch.from_numpy(prompts).to(dev)})
                tok = self._pick(logits)
            with obs.span("serve.pad_cache", batch=batch):
                cache = self._pad_cache(cache)  # prompt-length -> max_seq
            max_new = max(r.max_new for r in reqs)
            out = np.full((B, max_new), -1, np.int32)
            done = np.zeros(B, bool)
            if max_new:
                with obs.span("serve.token_sync", batch=batch):
                    got = tok.cpu().numpy()
                obs.instant("serve.first_token", batch=batch)
                with obs.span("serve.bookkeeping", batch=batch):
                    self._keep(reqs, out, done, got, 0)
            for t in range(1, max_new):
                if done.all():
                    break
                with obs.span("serve.decode", batch=batch, step=t):
                    logits, cache = self._decode(
                        torch.from_numpy(out[:, t - 1:t].copy()).to(dev),
                        cache)
                    tok = self._pick(logits)
                    with obs.span("serve.token_sync", batch=batch):
                        got = tok.cpu().numpy()
                    with obs.span("serve.bookkeeping", batch=batch):
                        self._keep(reqs, out, done, got, t)
        comps = []
        for i, r in enumerate(reqs):
            toks = out[i][out[i] >= 0][:r.max_new]
            comps.append(Completion(tokens=toks, steps=len(toks)))
        self._last_cache = cache
        return comps

    @staticmethod
    def _keep(reqs: list[Request], out: np.ndarray, done: np.ndarray,
              tok: np.ndarray, t: int) -> None:
        """Token ``t`` of every slot not yet done into ``out``; a slot is
        done at its ``eos_id`` or its ``max_new``-th token."""
        out[:, t] = np.where(done, -1, tok)
        for i, r in enumerate(reqs):
            if r.eos_id is not None and out[i, t] == r.eos_id:
                done[i] = True
            if t + 1 >= r.max_new:
                done[i] = True

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        # argmax takes the first of equal maxima, as jnp.argmax does
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _pad_cache(self, cache: dict) -> dict:
        """Grow sequence-axis leaves from prompt length to max_seq so
        decode has slots to write into."""
        out = dict(cache)
        for key in _SEQ_LEAVES:
            if key in out:
                arr = out[key]
                pad = self.max_seq - arr.shape[2]
                if pad > 0:
                    grown = arr.new_zeros((*arr.shape[:2], self.max_seq,
                                           *arr.shape[3:]))
                    grown[:, :, :arr.shape[2]] = arr
                    out[key] = grown
        return out

    # ------------------------------------------------------------ park
    def park_session(self, session: str, cache=None) -> None:
        if self.store is None:
            raise RuntimeError("no store attached")
        cache = self._last_cache if cache is None else cache
        seq_axes = {key: 2 for key, _ in pytree.flatten_with_keys(cache)
                    if any(f"'{leaf}'" in key for leaf in _SEQ_LEAVES)}
        kvcache.cache_to_objects(self.store, cache, session,
                                 seq_axes=seq_axes)

    def resume_session(self, session: str, batch: int) -> dict:
        """The parked cache, on the model's device."""
        if self.store is None:
            raise RuntimeError("no store attached")
        like = self.model.init_cache(batch, self.max_seq)
        return kvcache.objects_to_cache(self.store, like, session)
