"""Serving: the batched engine (``engine``), its step builders
(``steps``) and KV-cache pages in the store (``kvcache``)."""
