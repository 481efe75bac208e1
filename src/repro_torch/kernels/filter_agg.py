"""Fused predicate filter + per-tile partial aggregation on the H100.

The SkyhookDM ``filter -> agg`` tail as one pass over two columns: per
tile of ``block_rows * 128`` values (8192 by default, the reference's
tile), the predicate ``f32(filter) cmp f32(threshold)`` and the float32
partial ``[sum, count, min, max]`` of the selected values.  The CUDA
kernel is ``csrc/filter_agg.cu``; it replaces the reference's Pallas
kernel.  Public shapes:

  filter_agg(values, filter_col, cmp, thr)   (N,), (N,) -> (n_tiles, 4)
  combine_partials(partials)                 (n_tiles, 4) -> 4 scalars

The reference's (n_tiles, 4, 128) lane-replicated partials were a TPU
layout; here a tile's partial is one row.  Any N works: the ragged
last tile counts only its own rows.  The identities of an empty
selection are ``min = 3.4e38``, ``max = -3.4e38`` (float32), count and
sum 0; a selected NaN propagates into sum, min and max.

A CUDA tensor goes through the kernel, or the call raises.  A CPU tensor
goes through :func:`filter_agg_plain`, the same function in plain
PyTorch.  ``launches`` counts kernel launches.  This module also holds
what ``block_agg`` shares with it: the dtype codes of the launchers,
the plain per-tile reduction and :func:`combine_partials`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_ROWS = 64  # x 128 = 8192 values per tile
BIG = 3.4e38             # identity of min (max: -BIG), rounded to float32

# dtype codes of the launchers (csrc/agg_tile.cuh, enum Dtype)
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bool: 2,
               torch.uint8: 2}
VALUE_DTYPES = (torch.float32, torch.int32)

PREDICATES = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
              "==": torch.eq, "!=": torch.ne}
OPS = tuple(PREDICATES)  # index = the launcher's comparator code

launches = 0
_count_lock = threading.Lock()


def ensure_built() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = _build.load("filter_agg")
    fn = lib.filter_agg_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # the threshold is a C float: a double would promote the compare
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p]
    return lib


# --------------------------------------------------------------------------
# plain versions and the shared reduction
# --------------------------------------------------------------------------


def tile_partials_plain(v: torch.Tensor, m: torch.Tensor,
                        tile: int) -> torch.Tensor:
    """(N,) float32 values, (N,) bool mask -> (n_tiles, 4) float32 rows
    [sum, count, min, max] per tile of ``tile`` rows; the ragged last
    tile is padded with rows that fail the mask."""
    n = v.shape[0]
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
        m = torch.cat([m, m.new_zeros(pad)])
    v = v.reshape(n_tiles, tile)
    m = m.reshape(n_tiles, tile)
    big = torch.tensor(BIG, dtype=torch.float32, device=v.device)
    return torch.stack([torch.where(m, v, 0.0).sum(1),
                        m.to(torch.float32).sum(1),
                        torch.where(m, v, big).amin(1),
                        torch.where(m, v, -big).amax(1)], dim=1)


def filter_agg_plain(values: torch.Tensor, filter_col: torch.Tensor,
                     cmp: str, threshold, *,
                     block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N,), (N,) -> (n_tiles, 4),
    with the predicate f32(filter) cmp f32(threshold)."""
    thr = torch.tensor(float(threshold), dtype=torch.float32,
                       device=filter_col.device)
    m = PREDICATES[cmp](filter_col.to(torch.float32), thr)
    return tile_partials_plain(values.to(torch.float32), m, block_rows * 128)


def combine_partials(partials: torch.Tensor) -> dict[str, torch.Tensor]:
    """(n_tiles, 4) -> {"sum", "count", "min", "max"} 0-dim float32
    tensors.  Associative; min and max propagate NaN (``amin``/``amax``).
    No tiles give the identities."""
    if partials.shape[0] == 0:
        ident = torch.tensor([0.0, 0.0, BIG, -BIG], dtype=torch.float32,
                             device=partials.device)
        return dict(zip(("sum", "count", "min", "max"), ident.unbind()))
    return {"sum": partials[:, 0].sum(), "count": partials[:, 1].sum(),
            "min": partials[:, 2].amin(), "max": partials[:, 3].amax()}


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


def check_columns(values: torch.Tensor, other: torch.Tensor,
                  block_rows: int) -> None:
    if values.dim() != 1 or other.shape != values.shape:
        raise ValueError(f"want two (N,) columns, got {tuple(values.shape)} "
                         f"and {tuple(other.shape)}")
    if other.device != values.device:
        raise ValueError(f"columns on {values.device} and {other.device}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")


def kernel_input(x: torch.Tensor, dtypes) -> torch.Tensor:
    """``x`` as the kernel reads it: contiguous, and float32 when its
    dtype has no instantiation (the reference casts every column to
    float32 in the kernel body; the main path's dtypes have one)."""
    if x.dtype not in dtypes:
        x = x.to(torch.float32)
    return x.contiguous()


def _launch(values: torch.Tensor, filter_col: torch.Tensor, cmp: str,
            threshold, tile: int) -> torch.Tensor:
    global launches
    v = kernel_input(values, VALUE_DTYPES)
    f = kernel_input(filter_col, VALUE_DTYPES)
    n = v.shape[0]
    out = torch.empty((-(-n // tile), 4), dtype=torch.float32,
                      device=v.device)
    if n == 0:
        return out
    lib = ensure_built()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.filter_agg_launch(
            v.data_ptr(), DTYPE_CODES[v.dtype], f.data_ptr(),
            DTYPE_CODES[f.dtype], n, tile, OPS.index(cmp), float(threshold),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"filter_agg kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def filter_agg(values: torch.Tensor, filter_col: torch.Tensor, cmp: str,
               threshold, *,
               block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """(N,) values, (N,) filter column -> (n_tiles, 4) float32 partials
    on their device: the kernel for CUDA tensors, the plain version for
    CPU tensors.  Combine with :func:`combine_partials`."""
    if cmp not in OPS:
        raise ValueError(f"unknown comparator {cmp!r}")
    check_columns(values, filter_col, block_rows)
    if values.device.type == "cuda":
        return _launch(values, filter_col, cmp, threshold, block_rows * 128)
    if values.device.type == "cpu":
        return filter_agg_plain(values, filter_col, cmp, threshold,
                                block_rows=block_rows)
    raise ValueError(f"unsupported device {values.device}")
