"""Training launcher: ``python -m repro_torch.launch.train --arch yi_9b
--smoke``.

Stands up the object store, ingests a synthetic corpus through the VOL,
and runs the Trainer (object-store data path, packed ingest, checkpoint/
restart), as ``repro.launch.train`` does.  ``--smoke`` selects the
reduced config.  Runs on the card; ``--device cpu`` asks for the CPU,
the model and the store's bitpack decode both.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import GlobalVOL, make_store
from repro_torch.core import format as fmt
from repro_torch.core.partition import PartitionPolicy
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models.archs import build_model
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--packed", action="store_true", default=True)
    ap.add_argument("--no-packed", dest="packed", action="store_false")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-osds", type=int, default=8)
    ap.add_argument("--remat", choices=REMAT_POLICIES, default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.frontend != "none":
        raise SystemExit(f"{cfg.name}: modality-frontend archs train via "
                         "embedding stubs; use a token arch here")
    seq = args.seq or (2 * cfg.ssm.chunk if cfg.ssm is not None
                       and cfg.ssm.chunk <= 64 else 128)
    model = build_model(cfg, remat=args.remat, device=args.device)
    if torch.device(args.device).type == "cpu":
        fmt.set_bitunpack_backend("plain")

    store = make_store(args.n_osds, replicas=2)
    try:
        vol = GlobalVOL(store)
        build_corpus(vol, CorpusSpec(
            n_seqs=max(args.steps * args.global_batch // 2, 256),
            seq_len=seq, vocab_size=cfg.vocab_size, seed=args.seed),
            policy=PartitionPolicy(target_object_bytes=2 << 20,
                                   max_object_bytes=16 << 20))
        loader = ObjectDataLoader(vol, "corpus",
                                  global_batch=args.global_batch,
                                  seed=args.seed, packed=args.packed,
                                  prefetch=2)
        trainer = Trainer(
            model, loader, store,
            opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                          total_steps=args.steps),
            cfg=TrainerConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              log_every=max(args.steps // 10, 1),
                              packed_ingest=args.packed))
        try:
            trainer.run()
        finally:
            loader.close()
        print(f"[train] done: loss {trainer.history[0]['loss']:.3f} -> "
              f"{trainer.history[-1]['loss']:.3f}; "
              f"ckpts: {len(store.list_objects('ckpt/'))} objects")
    finally:
        store.close()


if __name__ == "__main__":
    main()
