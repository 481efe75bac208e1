"""The readings a cell's limits are set from, on the card at the cell's
own size (the benchmark's own runs never run this):

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6]

For each of ``--seeds``, the program's readings: the cell run through
the harness with the shortest window (training: one step past the
checked ones; serving: one batch), each number its comparison reads.
For each of ``--control-seeds``, the control's: the reference in
float8, the precision below the configuration's bfloat16, in the
program's place.  Training also reads its planted fault there (half of
each batch left out, the loss the mean over the rest); a state left
unchanged reads 1 by the comparison's measure and needs no run.  One
JSON line a reading, then a summary line of the largest program reading
and the smallest control reading of each number.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def program_readings(ctx_args: dict, seeds: list[int]) -> list[dict]:
    from perfbench import harness

    out = []
    for s in seeds:
        ctx = harness.Context(seed=s, t0=harness.now(), **ctx_args)
        line = harness.run_cell(ctx)
        rec = {"seed": s, "side": "program",
               "values": {k: c["value"] for k, c in line["checks"].items()
                          if c["value"] is not None}}
        emit(rec)
        out.append(rec)
    return out


def train_control(ctx_args: dict, seeds: list[int]) -> list[dict]:
    import numpy as np

    from perfbench import harness
    from perfbench.kinds import train_packed as tp
    from perfbench.reference import compare, lm

    cell = harness.find_cell(ctx_args["root"], ctx_args["workload"])
    spec = lm.spec_from_config(cell.config)
    layout = lm.param_layout(spec)
    B = cell.traffic["batch"]
    n = cell.traffic["check_steps"]
    probe = compare.probes(layout)
    out = []
    for s in seeds:
        ctx = harness.Context(seed=s, t0=harness.now(), **ctx_args)
        toks = tp.corpus_tokens(cell.traffic, spec.vocab, s)
        order = np.random.default_rng([s, 5]).permutation(len(toks))
        rows = [toks[order[k * B:(k + 1) * B]] for k in range(n)]
        t = time.perf_counter()
        ref = tp.reference_steps(ctx, cell, spec, layout, rows, probe)
        t_ref = time.perf_counter() - t
        ctl = tp.reference_steps(ctx, cell, spec, layout, rows, probe,
                                 num=lm.Numerics(fp8=True))
        half = tp.reference_steps(ctx, cell, spec, layout,
                                  [r[:B // 2] for r in rows], probe)
        for side, got in (("control", ctl), ("half_batch", half)):
            rec = {"seed": s, "side": side, "reference_s": t_ref,
                   "values": tp.compare_steps(got, ref)}
            emit(rec)
            out.append(rec)
    return out


def serve_control(ctx_args: dict, seeds: list[int]) -> list[dict]:
    """The program's run of each seed (its readings too), then at the
    same sampled prompts and served tokens the float8 reference's logits
    and first choices held against the float32 reference's."""
    from perfbench import harness
    from perfbench.kinds import serve_closed as sc
    from perfbench.reference import lm

    out, base = [], sc.readings

    def both(ctx, spec, layout, served, idx):
        got = base(ctx, spec, layout, served, idx)
        ctl = sc.reference_readings(ctx, spec, layout, served, idx,
                                    other=lm.Numerics(fp8=True))
        for side, vals in (("program", got), ("control", ctl)):
            rec = {"seed": ctx.seed, "side": side, "values": vals}
            emit(rec)
            out.append(rec)
        return got
    sc.readings = both
    try:
        for s in seeds:
            harness.run_cell(harness.Context(seed=s, t0=harness.now(),
                                             **ctx_args))
    finally:
        sc.readings = base
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    from perfbench.run import _environment

    _environment()
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    cell = harness.find_cell(ROOT, args.workload)
    ctx_args = dict(root=ROOT, workload=args.workload, seconds=0.0,
                    trace=False, device="cuda")
    recs = program_readings(ctx_args, seeds) if seeds else []
    if cell.traffic["kind"] == "train_packed":
        recs += train_control(ctx_args, ctl)
    else:
        recs += serve_control(ctx_args, ctl)
    summary: dict = {}
    for r in recs:
        for k, v in r["values"].items():
            d = summary.setdefault(k, {})
            if r["side"] == "program":
                d["lower"] = max(d.get("lower", 0.0), v)
            else:
                d[r["side"]] = min(d.get(r["side"], float("inf")), v)
    emit({"summary": summary, "seconds": time.perf_counter() - T0})
    found = harness.forbidden_modules()
    return 3 if found else 0


if __name__ == "__main__":
    sys.exit(main())
