"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository, on a machine with the
card(s) the cell asks for.  It sets up (imports, the program's kernel
build into its checkout on a first run, weights and data from the seed,
warm-up), measures for ``--seconds``, checks what the measured path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones
with ``--trace 1``), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), ``breakdown`` with ``--trace 1``, and ``checks`` (each
number compared, beside its limit), which are also the last lines on
standard error.  Without a CUDA card, or with fewer than the cell asks
for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches inside the checkout at fixed paths (the program's kernel
    library builds into its own ``src/repro_torch/build``); the
    allocator set as the program's own card scripts set it."""
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available; the benchmark runs "
              "only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    ctx = harness.Context(root=ROOT, workload=args.workload,
                          seed=args.seed % (1 << 63), seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", t0=T0)
    line = harness.run_cell(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
