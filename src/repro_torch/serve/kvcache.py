"""KV-cache pages as store objects.

Decode caches are the serving system's hot state; mapping cache *pages*
(fixed-size sequence stripes) to objects gives serving the same
durability story as training checkpoints: a preempted replica's sessions
resume on another host from the store.  MLA's latent cache (kv_lora 512)
is ~8x smaller per token than GQA kv=8, so its pages are proportionally
cheaper.

Leaves are tensors, on any device; keys, dtype names and page bytes come
from ``repro_torch.pytree``, so a page set written here and one written
by any other writer of the format are the same objects.
"""

from __future__ import annotations

import json
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.core.store import ObjectStore

PAGE_TOKENS = 2048


def _leaf_pages(arr: torch.Tensor, seq_axis: int) -> list[tuple]:
    S = arr.shape[seq_axis]
    return [(p0, arr.narrow(seq_axis, p0, min(PAGE_TOKENS, S - p0)))
            for p0 in range(0, S, PAGE_TOKENS)]


def cache_to_objects(store: ObjectStore, cache: Any, session: str,
                     *, seq_axes: dict[str, int]) -> dict:
    """Persist a decode cache; ``seq_axes`` maps leaf name -> sequence
    axis (leaves absent from the map are stored whole, e.g. SSM states).
    A page is cut on the leaf's own device and copied to the host whole.
    """
    manifest: dict = {"session": session, "leaves": {}}
    for key, leaf in pytree.flatten_with_keys(cache):
        arr = pytree.as_tensor(leaf)
        meta = {"dtype": pytree.DTYPE_NAMES[arr.dtype],
                "shape": list(arr.shape), "pages": []}
        names: list[str] = []
        blobs: list[bytes] = []
        axis = seq_axes.get(key)
        if axis is None:
            name = f"kv/{session}/{len(manifest['leaves']):04d}/whole"
            names.append(name)
            blobs.append(pytree.to_bytes(arr))
            meta["pages"].append([name, -1])
        else:
            meta["seq_axis"] = axis
            for p0, page in _leaf_pages(arr, axis):
                name = (f"kv/{session}/{len(manifest['leaves']):04d}/"
                        f"p{p0:08d}")
                names.append(name)
                blobs.append(pytree.to_bytes(page))
                meta["pages"].append([name, p0])
        # each leaf's pages ride the batched write plane (one request
        # per OSD per leaf, and at most one leaf buffered in memory —
        # pages are already materialized here, so the windowed
        # streaming mode would add feeder overhead with nothing left
        # to overlap)
        store.put_batch(names, blobs)
        manifest["leaves"][key] = meta
    # manifest LAST — the commit point stays ordered after the data
    store.put(f"kv/{session}/.manifest", json.dumps(manifest).encode())
    return manifest


def objects_to_cache(store: ObjectStore, cache_like: Any,
                     session: str) -> Any:
    """The cache ``cache_to_objects`` stored for ``session``, shaped like
    ``cache_like``; each leaf lands on the device of its ``cache_like``
    leaf (the host for arrays), page by page."""
    manifest = json.loads(store.get(f"kv/{session}/.manifest").decode())

    def leaf_of(key: str, like: Any) -> torch.Tensor:
        meta = manifest["leaves"][key]
        shape = tuple(meta["shape"])
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
        if meta["pages"][0][1] == -1:
            return pytree.from_bytes(store.get(meta["pages"][0][0]),
                                     meta["dtype"], shape, device)
        axis = meta["seq_axis"]
        arr = torch.empty(shape, dtype=pytree.DTYPES[meta["dtype"]],
                          device=device)
        for name, p0 in meta["pages"]:
            stop = min(p0 + PAGE_TOKENS, shape[axis])
            page_shape = list(shape)
            page_shape[axis] = stop - p0
            arr.narrow(axis, p0, stop - p0).copy_(pytree.from_bytes(
                store.get(name), meta["dtype"], page_shape, device))
        return arr

    return pytree.map_with_keys(leaf_of, cache_like)
