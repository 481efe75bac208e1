"""Variants of the bitunpack kernel, timed beside it on one card.

Each variant is ``src/repro_torch/csrc/bitunpack.cu`` with a few lines
replaced (the replacements must match the source, or the script stops).
All are built by nvcc at once, checked bit-exact against the plain
version (but "no transpose", which computes something else), and timed
by CUDA events around one call behind a GPU-side wait, in the order
kept, then reversed: at the scan's object column (696,320 values of
bitpack7), at the ingest batch (2^20 values of bitpack17) and at 2^28
values of 1, 7, 17 and 32 bits.  Beside them, two PyTorch calls give the
card's own ceilings for the traffic: ``zero_`` of 1 GiB (writes only)
and ``copy_`` of 0.57 GB (as many reads as writes).

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit:  python3 scripts/bitunpack_variants.py
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitunpack as bu  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
STCS = ("if (i < lim) dst[i] = x[u];", "if (i < lim) __stcs(dst + i, x[u]);")
_LOOP = "; ++s) {\n#pragma unroll\n        for (int u"   # the butterfly's
TRANSPOSE = ("for (int s = 0; s < 5" + _LOOP, "for (int s = 0; s < 0" + _LOOP)


def _bounds(k: int) -> tuple[str, str]:
    return ("__launch_bounds__(kThreads, 4)",
            f"__launch_bounds__(kThreads, {k})")


# name -> (replacements, stages, CTAs per SM, smallest tile)
VARIANTS = {
    "kept": ((), 3, 4, 32),
    "evict-first stores": ((STCS,), 3, 4, 32),
    "4 stages": ((("kStages = 3;", "kStages = 4;"),), 4, 4, 32),
    "2 CTAs per SM": ((_bounds(2),), 3, 2, 32),
    "8 CTAs per SM": ((_bounds(8),), 3, 8, 32),
    "8 groups per trip": ((("kUnroll = 4;", "kUnroll = 8;"),), 3, 4, 64),
    "no transpose": ((TRANSPOSE,), 3, 4, 32),
}


def build(name: str):
    src = (_build.CSRC / "bitunpack.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise SystemExit(f"variant {name!r}: {old!r} not in the source")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / name.replace(" ", "_")
    stem.with_suffix(".cu").write_text(src)
    lib = stem.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(stem.with_suffix(".cu"))],
                          capture_output=True, text=True, check=True)
    regs = [ln.split(":", 1)[1].strip() for ln in
            (proc.stdout + proc.stderr).splitlines() if "registers" in ln]
    fn = ctypes.CDLL(str(lib)).bitunpack_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return name, fn, regs


def caller(fn, name: str, words: torch.Tensor, bits: int, n: int,
           n_sms: int):
    """The variant's launch on ``words``, with :func:`bu.launch_plan`'s
    rule under the variant's stages, CTAs per SM and smallest tile."""
    _, stages, per_sm, min_tile = VARIANTS[name]
    groups = -(-n // 32)
    tile = next((t for t in bu.TILES if t >= min_tile
                 and -(-groups // t) >= 2 * n_sms), min_tile)
    n_tiles = -(-groups // tile)
    smem = stages * (tile * bits + 4) * 4
    fit = min(per_sm, bu.SMEM_PER_SM // (smem + bu.SMEM_RESERVED))
    grid = min(n_tiles, fit * n_sms)
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(words.data_ptr(), out.data_ptr(), groups, bits, n, tile,
                 grid, smem, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call, out


def isolated_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("bitunpack_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda:0")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    built = {}
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        for name, fn, regs in ex.map(build, VARIANTS):
            print(f"{name}: {'; '.join(regs)}")
            built[name] = fn

    gen = torch.Generator(device=dev).manual_seed(0)

    def words(n, bits):
        return torch.randint(-(1 << 31), 1 << 31, (-(-n // 32), bits),
                             dtype=torch.int32, device=dev, generator=gen)

    for bits, n in ((7, (1 << 24) + 17), (17, (1 << 24) + 17), (3, 1000),
                    (5, 5000), (32, 33)):
        w = words(n, bits)
        want = bu.bitunpack_plain(w, bits, n)
        for name, fn in built.items():
            call, out = caller(fn, name, w, bits, n, n_sms)
            call()
            torch.cuda.synchronize()
            if name != "no transpose" and not torch.equal(out, want):
                raise AssertionError(f"{name} differs: bits={bits} n={n}")
    print("every variant but 'no transpose' bit-exact against the plain "
          "version")

    big = torch.empty(1 << 28, dtype=torch.int32, device=dev)
    ms = isolated_ms(big.zero_, 15)
    bound = (1 << 30) / HBM_BYTES_PER_S * 1e3
    print(f"zero_ of 1 GiB: {ms:.5f} ms, {bound / ms:.1%} of its bound  "
          f"[{card}]")
    del big
    src = words(1 << 28, 17).reshape(-1)
    dst = torch.empty_like(src)
    ms = isolated_ms(lambda: dst.copy_(src), 15)
    print(f"copy_ of {src.numel() * 4 / 1e9:.2f} GB: {ms:.5f} ms, "
          f"{2 * src.numel() * 4 / HBM_BYTES_PER_S * 1e3 / ms:.1%} of its "
          f"bound  [{card}]")
    del src, dst

    for what, n, bits, iters in (("object column", 696_320, 7, 100),
                                 ("ingest batch", 1 << 20, 17, 100),
                                 ("2^28", 1 << 28, 1, 15),
                                 ("2^28", 1 << 28, 7, 15),
                                 ("2^28", 1 << 28, 17, 15),
                                 ("2^28", 1 << 28, 32, 15)):
        w = words(n, bits)
        got = {name: [] for name in built}
        for order in (list(built), list(built)[::-1]):
            for name in order:
                call, _ = caller(built[name], name, w, bits, n, n_sms)
                got[name].append(isolated_ms(call, iters))
        bound = n * (bits / 8 + 4) / HBM_BYTES_PER_S * 1e3
        print(f"{what} n={n} bitpack{bits}, bound {bound:.5f} ms  [{card}]")
        for name, t in got.items():
            print(f"  {name}: {t[0]:.5f} / {t[1]:.5f} ms, "
                  f"{bound / min(t):.1%} of the bound")
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())
