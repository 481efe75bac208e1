"""Planar bitpack decode (the storage codec's decode) on the H100.

Words of the ``bitpack<b>`` codec (``core.format``): each group of 32
values is ``bits`` uint32 words, word k holding bit k of all 32.  The
CUDA kernel ``csrc/bitunpack.cu`` replaces the reference's Pallas kernel
(``repro/kernels/bitunpack.py::_bitunpack_kernel``).  uint32 words and
values are carried as int32 tensors holding the same bits.

The kernel is bound by memory: n*bits/8 bytes read and 4n written, at
3.35 TB/s.  Its design, in the source's note:

- each CTA stages contiguous tiles of ``tile`` groups into shared memory
  with 16-byte ``cp.async``, ``STAGES`` = 3 deep, so two tiles' loads
  are in flight while one is transposed;
- the 32x32 bit transpose is a five-stage ``__shfl_xor_sync`` butterfly,
  15 instructions per group at any width (the bound leaves about 54 at
  bitpack17), four groups per warp per trip;
- words at any 4-byte offset (views such as ``packed[1:]``) are staged
  by 16-byte copies of their aligned body and 4-byte copies of the
  ragged head and tail, inside the kernel.

:func:`launch_plan` picks the geometry from the column's size: the
largest tile (256 down to 32 groups) that still gives every SM two
tiles, and a grid of at most ``BLOCKS_PER_SM`` CTAs per SM that walk
the tiles with a grid stride.

Public shapes follow the reference:

  bitunpack(words, bits=b)         (R, 4, b) int32 -> (R, 128) int32
  bitunpack_words(w, b, n, ...)    (G, b) uint32 numpy -> (n,) uint32 numpy

and ``bitunpack_groups(words, b, n)``, (G, b) int32 -> (n,) int32, the
tensor form both go through.

A CUDA tensor goes through the kernel, or the call raises.  A CPU tensor
goes through :func:`bitunpack_plain`, the same function in plain
PyTorch.  Both are the ``torch.library`` operator
``repro_torch::bitunpack``, whose fake implementation gives a fake
tensor mode the result's shape (the dry run, ``launch.dryrun``).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()

# the kernel's constants (csrc/bitunpack.cu), and the H100's limits
STAGES = 3                     # tiles resident in shared memory per CTA
TILES = (256, 128, 64, 32)     # groups per tile, largest first
BLOCKS_PER_SM = 4              # __launch_bounds__(256, 4)
SMEM_PER_SM = 233_472          # bytes of shared memory on an SM
SMEM_RESERVED = 1_024          # the runtime's share of each CTA

_sm_counts: dict[int, int] = {}


@dataclass(frozen=True)
class LaunchPlan:
    tile: int                  # groups per tile
    n_tiles: int
    grid: int                  # CTAs; CTA b takes tiles b, b + grid, ...
    smem_bytes: int            # STAGES stages of tile*bits + 4 words


@functools.lru_cache(maxsize=1024)    # a scan asks for a few shapes often
def launch_plan(n_groups: int, bits: int, n_sms: int) -> LaunchPlan:
    """The kernel's geometry for ``n_groups`` groups of ``bits`` words on
    a card of ``n_sms`` SMs.  A stage holds ``tile * bits + 4`` words: a
    tile's words start at any 4-byte offset within a 16-byte line and
    keep it in shared memory, and the stride stays a multiple of 16
    bytes (``tile * bits`` is a multiple of 32)."""
    for tile in TILES:
        if -(-n_groups // tile) >= 2 * n_sms:
            break
    n_tiles = -(-n_groups // tile)
    smem = STAGES * (tile * bits + 4) * 4
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return LaunchPlan(tile, n_tiles, min(n_tiles, per_sm * n_sms), smem)


def _sm_count(device: torch.device) -> int:
    idx = device.index                 # set on every CUDA tensor's device
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def ensure_built() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = _build.load("bitunpack")
    fn = lib.bitunpack_launch
    if fn.argtypes is None:
        # restype before argtypes: another thread that sees argtypes
        # set calls straight away.  c_void_p keeps pointers 64-bit.
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def bitunpack_plain(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(G, bits) int32 -> (n,) int32: the kernel's function in plain
    PyTorch.  Works on int64, because uint32 has no ``>>`` on the CPU."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    lane = torch.arange(32, dtype=torch.int64, device=w.device)
    vals = torch.zeros((w.shape[0], 32), dtype=torch.int64, device=w.device)
    for k in range(bits):
        vals |= ((w[:, k, None] >> lane) & 1) << k
    vals = vals.reshape(-1)[:n]
    return torch.where(vals >= 1 << 31, vals - (1 << 32), vals).to(torch.int32)


def _check(words: torch.Tensor, bits: int, n: int) -> None:
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 (uint32 bits), got {words.dtype}")
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if words.dim() != 2 or words.shape[1] != bits:
        raise ValueError(f"want (G, {bits}) words, got {tuple(words.shape)}")
    if not 0 <= n <= 32 * words.shape[0]:
        raise ValueError(f"n={n} exceeds {words.shape[0]} groups of 32")


def _launch(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(G, bits) int32 on a CUDA device -> (n,) int32 there, by the
    kernel.  The words may start at any 4-byte offset."""
    global launches
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    lib = ensure_built()
    n_groups = -(-n // 32)             # the groups the n values occupy
    plan = launch_plan(n_groups, bits, _sm_count(words.device))
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.bitunpack_launch(words.data_ptr(), out.data_ptr(),
                                   n_groups, bits, n, plan.tile, plan.grid,
                                   plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"bitunpack kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


# One operator, ``repro_torch::bitunpack(words, bits, n)``, so that a
# fake tensor mode (the dry run's) traces it: CUDA launches the kernel,
# the CPU runs the plain version, a fake or meta tensor gets its (n,)
# int32 result; any other device has no kernel and raises.
@torch.library.custom_op("repro_torch::bitunpack", mutates_args=(),
                         device_types="cpu")
def _bitunpack_op(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    return bitunpack_plain(words, bits, n)


@_bitunpack_op.register_kernel("cuda")
def _bitunpack_cuda(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    return _launch(words, bits, n)


@_bitunpack_op.register_fake
def _bitunpack_fake(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    return words.new_empty((n,), dtype=torch.int32)


def bitunpack_groups(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(G, bits) int32 -> (n,) int32 on the words' device, through the
    ``repro_torch::bitunpack`` operator: the kernel for a CUDA tensor,
    the plain version for a CPU tensor, the result's shape alone for a
    fake one."""
    _check(words, bits, n)
    if words.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {words.device}")
    return _bitunpack_op(words, bits, n)


def bitunpack(words: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(R, 4, bits) int32 -> (R, 128) int32, the reference's tile shape."""
    if words.dim() != 3 or tuple(words.shape[1:]) != (4, bits):
        raise ValueError(f"want (R, 4, {bits}), got {tuple(words.shape)}")
    R = words.shape[0]
    return bitunpack_groups(words.reshape(4 * R, bits), bits,
                            128 * R).reshape(R, 128)


def bitunpack_words(words: np.ndarray, bits: int, n: int, *,
                    device: str | torch.device = "cuda:0") -> np.ndarray:
    """(G, bits) uint32 planar words -> (n,) uint32, decoded on ``device``.

    Host adapter for the scan path (``format._decode_column``).  The
    words are usually a read-only view into a block at any byte offset,
    so they are first copied into an aligned host tensor (pinned when
    the decode runs on the card), moved to ``device``, decoded, and the
    values brought back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bitunpack on the card: no CUDA device is "
                           "available")
    w = np.asarray(words)
    if w.dtype != np.uint32:
        w = w.astype(np.uint32)
    if w.size % bits:
        raise ValueError(f"{w.size} words is not a whole number of "
                         f"{bits}-word groups")
    host = torch.empty(w.size, dtype=torch.int32,
                       pin_memory=dev.type == "cuda")
    host.numpy()[...] = w.reshape(-1).view(np.int32)
    vals = bitunpack_groups(host.to(dev, non_blocking=True).reshape(-1, bits),
                            bits, n)
    return vals.cpu().numpy().view(np.uint32)
