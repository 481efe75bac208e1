"""Nested state trees (dicts, lists, tuples and named tuples of tensors)
flattened to named leaves, and leaves to and from their stored bytes,
the way checkpoints and KV pages keep them.

A leaf's key is the path from the root written as the store's byte
formats spell it: ``['params']['w']`` for dict keys, ``[0]`` for list
and tuple positions, ``.name`` for named-tuple fields.  Dict entries
are visited in sorted key order and ``None`` holds no leaf, so the keys
and their order are those of the manifests already in the store.

A leaf is stored as its raw little-endian bytes in C order under a
numpy dtype name (``"bfloat16"`` for bf16), through the table below;
no numpy bf16 type is needed to read or write one.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

DTYPE_NAMES: dict[torch.dtype, str] = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.uint16: "uint16",
    torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
DTYPES: dict[str, torch.dtype] = {v: k for k, v in DTYPE_NAMES.items()}


def as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, arrays and Python
    scalars through numpy (so ``7`` is int64, as numpy makes it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def host_copy(leaf: Any) -> torch.Tensor:
    """A host tensor that shares no memory with ``leaf``; a device
    leaf is copied synchronously, so the copy is complete on return."""
    return as_tensor(leaf).to("cpu", copy=True)


def to_bytes(t: torch.Tensor) -> bytes:
    """The tensor's values, C order, as raw bytes: made contiguous on
    its own device, then read from the host."""
    t = t.detach().contiguous().to("cpu").reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def from_bytes(raw: bytes | bytearray, dtype: str, shape,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """The tensor whose :func:`to_bytes` is ``raw``, on ``device``."""
    dt = DTYPES[dtype]
    shape = tuple(shape)
    if not len(raw):
        return torch.empty(shape, dtype=dt, device=device)
    if not isinstance(raw, bytearray):
        raw = bytearray(raw)          # frombuffer wants a writable buffer
    flat = torch.frombuffer(raw, dtype=torch.uint8).view(dt)
    return flat.reshape(shape).to(device)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """``(key, leaf)`` for every leaf of ``tree``, in traversal order."""
    out: list[tuple[str, Any]] = []

    def walk(node, path: str) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), f"{path}.{f}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def map_with_keys(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; the
    containers keep their types."""

    def walk(node, path: str):
        if node is None:
            return None
        if isinstance(node, dict):
            return type(node)((k, walk(node[k], f"{path}[{k!r}]"))
                              for k in sorted(node))
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), f"{path}.{f}")
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}[{i}]")
                              for i, v in enumerate(node))
        return fn(path, node)

    return walk(tree, "")
