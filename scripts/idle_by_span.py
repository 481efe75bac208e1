"""The card's idle time in one benchmark cell, named by the program's own
spans.

    python3 scripts/idle_by_span.py --workload <cell> [--seed N] \
        [--seconds S] [--out PATH]

from the root of a checkout, on a machine with the card.  It runs the
cell traced through the benchmark's harness (``perfbench.harness.
run_cell``, what ``perfbench/run.py --trace 1`` runs) and, in this
process only, reduces the device trace once more (``perfbench.trace.
reduce``) with the benchmark's spans plus the program's main-thread
spans (``repro_torch.obs``, which records while the profiler does).
The loader's producer-thread spans are left out: they overlap the main
thread's and would take its gaps.  Each idle gap is named by the span
that started last among those open at its middle.

It prints the cell's result line, then the idle seconds by span twice:
with every main-thread span, and without the model's layer spans
(``model.*``), so that the engine's and the Trainer's parts keep the
time of the layers they launch.  Each table is the ten largest entries
with the rest summed.  The line and the tables are also written to
``--out`` (default ``results/idle_by_span.<cell>.json``).  The
benchmark's own files are used as they are: only this process's
``Tracer.summary`` is wrapped.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def program_spans(layers: bool) -> list[tuple[str, float, float]]:
    """The program's spans on this thread as (name, start s, end s)."""
    from repro_torch import obs

    me = threading.get_ident()
    return [(s.name, s.start_s, s.end_s) for s in obs.spans()
            if s.thread == me and (layers or not s.name.startswith("model."))]


def table(summary: dict) -> list:
    """The idle gaps as [name, s] with the rest of the idle time last."""
    idle = summary["window_s"] - summary["busy_s"]
    rows = [list(r) for r in summary["idle_gaps"]]
    rows.append(["(the rest)", idle - sum(s for _, s in rows)])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483713)
    ap.add_argument("--seconds", type=float, default=38.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run as bench_run

    bench_run._environment()
    import torch

    if not torch.cuda.is_available():
        print("idle_by_span: no CUDA device is available", file=sys.stderr)
        return 2
    from perfbench import harness, trace

    tables: dict = {}
    summary = trace.Tracer.summary

    def named(self, spans):
        out = summary(self, spans)
        ev = self.events()
        marks = [s for s, _, n in ev if trace.MARKER in n]
        offset = (marks[0] - self.marker_host_ns) if marks else None
        ev = [e for e in ev if trace.MARKER not in e[2]]
        for key, layers in (("every span", True), ("no model.*", False)):
            tables[key] = table(trace.reduce(
                ev, self.host, offset, list(spans) + program_spans(layers)))
        tables["benchmark spans"] = table(out)
        tables["window_s"], tables["busy_s"] = out["window_s"], out["busy_s"]
        return out
    trace.Tracer.summary = named
    print(f"card: {bench_run.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    ctx = harness.Context(root=ROOT, workload=args.workload,
                          seed=args.seed % (1 << 63), seconds=args.seconds,
                          trace=True, device="cuda", t0=T0)
    line = harness.run_cell(ctx)
    print(json.dumps(line))
    print(f"traced window {tables['window_s']:.6f} s, busy "
          f"{tables['busy_s']:.6f} s")
    for key in ("benchmark spans", "every span", "no model.*"):
        print(f"idle by span ({key}):")
        for name, s in tables[key]:
            print(f"  {name:32s} {s:.6f} s")
    out = args.out or ROOT / "results" / f"idle_by_span.{args.workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"line": line, "tables": tables}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
