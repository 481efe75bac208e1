"""Planar bitpack decode (the storage codec's decode) on the H100.

Words of the ``bitpack<b>`` codec (``core.format``): each group of 32
values is ``bits`` uint32 words, word k holding bit k of all 32.  The
CUDA kernel is ``csrc/bitunpack.cu`` (one warp per group, a ballot per
value); it replaces the reference's Pallas kernel.  uint32 words and
values are carried as int32 tensors holding the same bits.

Public shapes follow the reference:

  bitunpack(words, bits=b)         (R, 4, b) int32 -> (R, 128) int32
  bitunpack_words(w, b, n, ...)    (G, b) uint32 numpy -> (n,) uint32 numpy

and ``bitunpack_groups(words, b, n)``, (G, b) int32 -> (n,) int32, the
tensor form both go through.

A CUDA tensor goes through the kernel, or the call raises.  A CPU tensor
goes through :func:`bitunpack_plain`, the same function in plain
PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()


def ensure_built() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = _build.load("bitunpack")
    fn = lib.bitunpack_launch
    if fn.argtypes is None:
        # restype before argtypes: another thread that sees argtypes
        # set calls straight away.  c_void_p keeps pointers 64-bit.
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
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
    """(G, bits) int32 on a CUDA device -> (n,) int32 there, by the kernel."""
    global launches
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    lib = ensure_built()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.bitunpack_launch(words.data_ptr(), out.data_ptr(),
                                   words.shape[0], bits, n, stream)
    if err != 0:
        raise RuntimeError(f"bitunpack kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def bitunpack_groups(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(G, bits) int32 -> (n,) int32 on the words' device: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    _check(words, bits, n)
    if words.device.type == "cuda":
        return _launch(words, bits, n)
    if words.device.type == "cpu":
        return bitunpack_plain(words, bits, n)
    raise ValueError(f"unsupported device {words.device}")


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
