"""Serving step builders: prefill (prompt -> cache) and decode (1 token)."""

from __future__ import annotations

from repro_torch import obs


def make_prefill_step(model):
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model):
    """The decode step, the span ``serve.decode.launch`` inside it: below
    any wrapper a caller sets around it, so the span is the host's time
    to enqueue the step."""
    def serve_step(tokens, cache):
        with obs.span("serve.decode.launch"):
            return model.decode_step(tokens, cache)
    return serve_step
