"""Flash-attention forward for inference on the H100.

``csrc/flash_fwd.cu`` replaces no Pallas kernel: the reference's prefill
attention is its blockwise scan, which the port carries as a loop of
plain PyTorch operators (``models/attention.py::_flash_fwd``).  On the
inference path that loop keeps float32 scores of every 512 x 512 block
pair in device memory; this kernel keeps S and P in registers, one
launch a layer.  ``attention.flash_attention`` routes a call here only
where no gradient is wanted (the forward alone: no LSE is kept, and
there is no backward), q, k and v are bf16 on a CUDA device with head
widths of 128, and the heads are whole.

It computes what the loop computes, in the same arithmetic: bf16
operands, QK^T accumulated in float32 and scaled by ``128 ** -0.5``, the
causal mask ``q_offset + i >= j`` (none when not causal), the online
softmax in float32, P rounded to bf16 for the PV product accumulated in
float32, and ``O / max(l, 1e-20)`` in bf16.  Query head h reads KV head
h // G in place.  It walks the keys in tiles of ``BLOCK_N`` rather than
the loop's 512, so P is rounded against another running maximum: the
two agree to the rounding of P and of the output (``tests/
test_torch_flash_fwd.py`` states the tolerance).  The loop stays the
function's one plain version.

The kernel is bound by the tensor cores (4 * B * H * 128 * Sq * Sk / 2
FLOPs causal, at 989 TFLOP/s; :func:`bound_ms`).  Its design, in the
source's note: work tiles of 128 query rows of one (batch, head), the G
heads of a KV group adjacent and the longest causal tiles first, walked
by one persistent CTA an SM; a producer warp keeping TMA loads of
128-key K and V tiles (and the next tile's Q) in flight under
``mbarrier``s; two consumer warpgroups running ``wgmma`` for S and for
PV with P as the register operand; only tiles that cross the diagonal
masked.

Shapes: q (B, Sq, H, 128), k and v (B, Sk, K, 128), H a multiple of K,
``q_offset`` >= 0 -> (B, Sq, H, 128), all bf16.

A CUDA tensor goes through the kernel, or the call raises; so does a
tensor on any other device.  The kernel is the ``torch.library``
operator ``repro_torch::flash_fwd``, whose fake implementation gives a
fake tensor mode (the dry run, ``launch.dryrun``) and meta tensors the
result's shape.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()

# the kernel's constants (csrc/flash_fwd.cu)
HEAD_DIM = 128                 # q, k and v head widths it takes
BLOCK_N = 128                  # keys a tile
PEAK_FLOPS = 989e12            # H100 SXM dense bf16 (data sheet)


def ensure_built() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_launch
    if fn.argtypes is None:
        # restype before argtypes: another thread that sees argtypes
        # set calls straight away.  c_void_p keeps pointers 64-bit.
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
    return lib


def causal_flops(B: int, Sq: int, Sk: int, H: int, causal: bool = True,
                 q_offset: int = 0) -> float:
    """FLOPs of QK^T and PV (head widths 128) over the (query, key)
    pairs the mask keeps: 2 * 2 * 128 a pair."""
    if not causal:
        pairs = Sq * Sk
    else:  # row i keeps keys 0 .. min(q_offset + i, Sk - 1)
        pairs = sum(max(0, min(q_offset + i + 1, Sk)) for i in range(Sq))
    return 4.0 * B * H * HEAD_DIM * pairs


def bound_ms(B: int, Sq: int, Sk: int, H: int, causal: bool = True,
             q_offset: int = 0) -> float:
    """The least time of one call on an H100: its FLOPs at the dense
    bf16 peak (the bytes, q, k, v and the output once, take less)."""
    return causal_flops(B, Sq, Sk, H, causal, q_offset) / PEAK_FLOPS * 1e3


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd: {name} must be bf16, got {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"flash_fwd: {name} must be (B, S, heads, "
                             f"{HEAD_DIM}), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_fwd: {name} on {t.device}, q on "
                             f"{q.device}")
    B, _, H, _ = q.shape
    if k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_fwd: {H} query heads over {k.shape[2]} KV "
                         f"heads")
    if q_offset < 0:
        raise ValueError(f"flash_fwd: q_offset {q_offset} < 0")
    if max(t.numel() for t in (q, k, v)) >= 1 << 31:
        raise ValueError("flash_fwd: a tensor of 2^31 elements or more")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int) -> torch.Tensor:
    """The kernel on q's CUDA device, on its current stream."""
    global launches
    q, k, v = (t.contiguous() for t in (q, k, v))
    B, Sq, H, hd = q.shape
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        raise ValueError("flash_fwd: no keys")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k and v must start on 16 bytes "
                         "(the tensor maps' rule)")
    lib = ensure_built()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), B, Sq, k.shape[1], H,
                                   k.shape[2], int(causal), q_offset,
                                   hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           + (f"CUDA error {err}" if err > 0 else
                              f"tensor map error {err}"))
    with _count_lock:
        launches += 1
    return out


# One operator, ``repro_torch::flash_fwd(q, k, v, causal, q_offset)``,
# so that a fake tensor mode (the dry run's) traces it: CUDA launches the
# kernel, a fake or meta tensor gets its (B, Sq, H, 128) bf16 result;
# any other device has no kernel and raises.
# Defined through ``torch.library.Library`` rather than ``custom_op``:
# custom_op's backend functions import ``torch._dynamo`` on their first
# call, about 3 s of a serving process's set-up, on the inference path.
_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int q_offset) -> Tensor")
_lib.impl("flash_fwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_fwd", lib=_lib)
def _flash_fwd_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int) -> torch.Tensor:
    return q.new_empty(q.shape)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(B, Sq, H, 128) attention of q over k and v, bf16, through the
    ``repro_torch::flash_fwd`` operator: the kernel for CUDA tensors,
    the result's shape alone for fake and meta ones."""
    _check(q, k, v, q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return torch.ops.repro_torch.flash_fwd(q, k, v, bool(causal),
                                          int(q_offset))
