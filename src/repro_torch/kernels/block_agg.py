"""Masked per-tile partial aggregation on the H100.

The terminal ``agg`` when the validity mask is already materialised
(tokens != pad, or a composed upstream filter): per tile of
``block_rows * 128`` values, the float32 partial ``[sum, count, min,
max]`` over the rows whose mask is nonzero.  The CUDA kernel is
``csrc/block_agg.cu``; it replaces the reference's Pallas kernel.

  block_agg(values, mask)    (N,), (N,) -> (n_tiles, 4) float32

Any N works (the ragged last tile counts only its own rows); combine
with ``filter_agg.combine_partials``.  Masks of bool, uint8 and int32
are read as they lie; another mask dtype is first cast to int32, as the
reference's wrapper casts every mask.

A CUDA tensor goes through the kernel, or the call raises.  A CPU tensor
goes through :func:`block_agg_plain`.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.filter_agg import (
    DEFAULT_BLOCK_ROWS, DTYPE_CODES, VALUE_DTYPES, check_columns,
    kernel_input, tile_partials_plain)

MASK_DTYPES = (torch.bool, torch.uint8, torch.int32)

launches = 0
_count_lock = threading.Lock()


def ensure_built() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = _build.load("block_agg")
    fn = lib.block_agg_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _mask(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dtype in MASK_DTYPES else mask.to(torch.int32)


def block_agg_plain(values: torch.Tensor, mask: torch.Tensor, *,
                    block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N,), (N,) -> (n_tiles, 4)."""
    return tile_partials_plain(values.to(torch.float32), _mask(mask) != 0,
                               block_rows * 128)


def _launch(values: torch.Tensor, mask: torch.Tensor,
            tile: int) -> torch.Tensor:
    global launches
    v = kernel_input(values, VALUE_DTYPES)
    m = _mask(mask).contiguous()
    n = v.shape[0]
    out = torch.empty((-(-n // tile), 4), dtype=torch.float32,
                      device=v.device)
    if n == 0:
        return out
    lib = ensure_built()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.block_agg_launch(
            v.data_ptr(), DTYPE_CODES[v.dtype], m.data_ptr(),
            DTYPE_CODES[m.dtype], n, tile, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"block_agg kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def block_agg(values: torch.Tensor, mask: torch.Tensor, *,
              block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """(N,) values, (N,) mask (nonzero = keep) -> (n_tiles, 4) float32
    partials on their device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    check_columns(values, mask, block_rows)
    if values.device.type == "cuda":
        return _launch(values, mask, block_rows * 128)
    if values.device.type == "cpu":
        return block_agg_plain(values, mask, block_rows=block_rows)
    raise ValueError(f"unsupported device {values.device}")
