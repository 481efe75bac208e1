"""The loss's head product under ``XENT_MM = "mixed"`` and ``"cast"``
at one learning rate, on the card: yi_9b at 1 layer and starcoder2_7b at
4 layers, full width, bf16, each through ``chip_smoke.train_run`` (5
packed-ingest steps of 4 x 4096 tokens, the same seed and corpus for
both switches).  Prints each run's losses and, last, one JSON line of
them all.  It answers whether a loss that rises at that learning rate
rises under both switches (the arithmetic the reference has at either
setting) or only under one.

Run from the root of a checkout, on a machine with a card:
    python3 scripts/xent_lr_check.py [--lr 1e-4] [--seed 0]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

RUNS = (("yi_9b", 1), ("starcoder2_7b", 4))
SWITCHES = ("mixed", "cast")


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        print("xent_lr_check: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    P = cs._load_port()
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    P.bu.ensure_built()
    out = []
    for arch, layers in RUNS:
        for mode in SWITCHES:
            P.layers.XENT_MM = mode
            tag = f"{arch} {layers} layers XENT_MM={mode} lr {args.lr:g}"
            res = cs.train_run(P, dev, args.seed, card, arch, layers, tag,
                               "a learning-rate check", args.lr)
            out.append({"arch": arch, "layers": layers, "XENT_MM": mode,
                        "lr": args.lr, "losses": res["losses"],
                        "grad_norms": res["grad_norms"],
                        "step_mean_s": res["step_mean_s"]})
            print(f"xent_lr_check: {tag}: losses "
                  f"{[round(x, 4) for x in res['losses']]}  [{card}]",
                  flush=True)
    P.layers.XENT_MM = "mixed"
    print(json.dumps({"card": card, "runs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
