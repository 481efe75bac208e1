"""Serving step builders: prefill (prompt -> cache) and decode (1 token)."""

from __future__ import annotations


def make_prefill_step(model):
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model):
    def serve_step(tokens, cache):
        return model.decode_step(tokens, cache)
    return serve_step
