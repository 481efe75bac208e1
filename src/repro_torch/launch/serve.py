"""Serving launcher: ``python -m repro_torch.launch.serve --arch yi_9b
--smoke``.

Boots the engine with random weights from ``--seed``, serves synthetic
batched requests, and parks the session's KV pages to the object store.
Runs on the card; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import make_store
from repro_torch.models.archs import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.frontend != "none":
        raise SystemExit(f"{cfg.name}: frontend-stub archs decode over "
                         "token ids after a stubbed prefill; use the "
                         "dryrun for their serve-step lowering")
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=args.device).manual_seed(args.seed))
    store = make_store(4, replicas=2)
    try:
        engine = ServeEngine(model, max_seq=args.max_seq, store=store)
        rng = np.random.default_rng(args.seed)
        reqs = [Request(prompt=rng.integers(
            1, cfg.vocab_size, int(rng.integers(4, 17))).astype(np.int32),
            max_new=args.max_new) for _ in range(args.batch)]
        t0 = time.perf_counter()
        comps = engine.generate(reqs)
        dt = time.perf_counter() - t0
        toks = sum(c.steps for c in comps)
        print(f"[serve] {args.batch} reqs, {toks} tokens, "
              f"{dt * 1e3:.0f} ms ({toks / dt:.1f} tok/s)")
        engine.park_session("session-0")
        print(f"[serve] parked KV pages: "
              f"{len(store.list_objects('kv/'))} objects")
    finally:
        store.close()


if __name__ == "__main__":
    main()
