"""Serving state in the object store: KV-cache pages (``kvcache``)."""
