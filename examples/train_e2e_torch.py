"""End-to-end training on the PyTorch/CUDA port (``repro_torch``): an LM
of up to ~100M parameters trained with the entire data and checkpoint
path on the object store.

    PYTHONPATH=src python examples/train_e2e_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_e2e_torch.py --preset 25m  --steps 200
    PYTHONPATH=src python examples/train_e2e_torch.py --preset tiny --steps 40 --device cpu

The dataset is mapped to objects with planar-bitpacked token columns;
the loader fetches packed rows with the zero-decode ``select_packed``
objclass op and hedges stragglers; the unpack runs on the model's
device in front of the step (the ``bitunpack`` CUDA kernel on the
card); checkpoints are replicated objects committed manifest-last; an
OSD is killed mid-run and the run continues.  Parameters are float32.
``--device cuda`` (the default) needs a card and raises without one.

Results land in ``--out`` (default ``results/train_e2e_torch_<preset>.json``).
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import GlobalVOL, make_store
from repro_torch.core import format as fmt
from repro_torch.core.partition import PartitionPolicy
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models import attention, layers
from repro_torch.models.archs import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # ~103M params: 12L d=768 (gpt2-small-ish, llama-style blocks)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32_000,
                 batch=8, seq=256),
    # ~27M params
    "25m": dict(n_layers=8, d_model=448, n_heads=8, n_kv_heads=4,
                head_dim=56, d_ff=1280, vocab_size=16_000,
                batch=8, seq=256),
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=384, vocab_size=2_000,
                 batch=8, seq=128),
}

RESULTS = pathlib.Path(__file__).resolve().parents[1] / "results"


def make_cfg(p: dict) -> ArchConfig:
    return ArchConfig(
        name="train_e2e", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"],
        param_dtype=torch.float32, compute_dtype=torch.float32)


def use_device(name: str) -> torch.device:
    """The device an example runs on, with the store's bitpack decode to
    match: the CUDA kernel on a card (raises without one), the kernel's
    plain version on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        fmt.set_bitunpack_backend("device")
    else:
        fmt.set_bitunpack_backend("plain")
    return dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kill-osd-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="results file (default results/"
                         "train_e2e_torch_<preset>.json)")
    args = ap.parse_args(argv)
    backend = fmt.get_bitunpack_backend()
    try:
        dev = use_device(args.device)
        store = make_store(8, replicas=2)
        try:
            return _run(args, dev, store)
        finally:
            store.close()
    finally:
        fmt.set_bitunpack_backend(backend)


def _run(args, dev: torch.device, store) -> dict:
    p = PRESETS[args.preset]
    cfg = make_cfg(p)
    switches = {"HEAD_TP": attention.HEAD_TP, "XENT_MM": layers.XENT_MM}
    print(f"[e2e] {args.preset}: {cfg.param_count() / 1e6:.1f}M params "
          f"on {dev}; " + " ".join(f"{k}={v}" for k, v in switches.items()))

    vol = GlobalVOL(store)
    n_seqs = max(args.steps * p["batch"] // 4, 512)  # ~4 epochs
    build_corpus(vol, CorpusSpec(n_seqs=n_seqs, seq_len=p["seq"],
                                 vocab_size=cfg.vocab_size,
                                 seed=args.seed),
                 policy=PartitionPolicy(target_object_bytes=2 << 20,
                                        max_object_bytes=16 << 20))
    print(f"[e2e] corpus: {n_seqs} x {p['seq']} tokens in "
          f"{store.stats()['n_objects']} objects")

    model = build_model(cfg, remat="none", device=dev)
    loader = ObjectDataLoader(vol, "corpus", global_batch=p["batch"],
                              seed=args.seed, packed=True, prefetch=2,
                              hedge_timeout_s=0.5)
    kill_at = args.kill_osd_at or args.steps // 2
    out_file = args.out or RESULTS / f"train_e2e_torch_{args.preset}.json"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    killed = {}

    def summary(history) -> dict:
        losses = [h["loss"] for h in history]
        return {
            "preset": args.preset, "device": str(dev), "switches": switches,
            "params_m": cfg.param_count() / 1e6,
            "steps_done": len(losses), "steps_target": args.steps,
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_curve": losses[:: max(len(losses) // 50, 1)],
            "wall_s_per_step": float(np.mean(
                [h["wall_s"] for h in history[2:]] or [0.0])),
        }

    def on_step(step: int) -> None:
        if step == kill_at:
            victim = store.cluster.up_osds[0]
            store.fail_osd(victim)
            rec = store.recover()
            killed.update(osd=victim, step=step, **rec)
            print(f"[e2e] step {step}: killed {victim}; recovery moved "
                  f"{rec['objects_moved']} replicas, lost "
                  f"{rec['objects_lost']}")
        if step % 10 == 0:
            out_file.write_text(json.dumps(summary(trainer.history),
                                           indent=1))

    trainer = Trainer(
        model, loader, store,
        opt=OptConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps),
        cfg=TrainerConfig(total_steps=args.steps,
                          ckpt_every=max(args.steps // 4, 10),
                          log_every=max(args.steps // 20, 5),
                          packed_ingest=True))
    try:
        trainer.run(on_step=on_step)
    finally:
        loader.close()

    out = summary(trainer.history)
    out.update(steps=args.steps, killed=killed,
               stragglers_flagged=trainer.straggler.flagged,
               checkpoints=len(store.list_objects("ckpt/")),
               store=store.stats()["fabric"])
    out_file.write_text(json.dumps(out, indent=1))
    print(f"[e2e] loss {out['loss_first']:.3f} -> {out['loss_last']:.3f} "
          f"over {args.steps} steps "
          f"({out['wall_s_per_step'] * 1e3:.0f} ms/step); "
          f"results -> {out_file}")
    assert all(np.isfinite([h["loss"] for h in trainer.history]))
    assert killed and killed["objects_lost"] == 0, killed
    assert out["loss_last"] < out["loss_first"], "training must learn"
    return out


if __name__ == "__main__":
    main()
