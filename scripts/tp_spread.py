"""How far the port's model axis moves zamba2_2p7b's first-step gradients
and served logits, beside how far other float32 evaluations of the same
model move them on one device.

Builds one group of zamba2_2p7b (6 Mamba2 layers and the shared block)
in float32, at its published widths (``--d-model 0``) or a cut one
(heads, head dims and d_ff scaled with it), with ``chip_smoke.py``'s
seeded weights, on ``--device``.  Takes one loss's gradients of the
first step's 2 x 1024 tokens of ``chip_smoke.py``'s phase 26 (a) and
serves its 4 prompts of 1024 tokens with 16 greedy decode steps (the
first packed batch of its corpus, in the model's vocabulary), four
ways:

- on one device (the baseline);
- on one device with each split layer's output (every
  ``layers.tp_combine`` of the Mamba2 layers and the shared block)
  scaled by ``1 + 2**-24 N(0, 1)`` entry by entry: one rounding's change
  where the model axis changes the order of a sum, one draw a seed
  (``--seeds``);
- on one device serving one prompt at a time (logits only): the same
  float32 arithmetic in products of other shapes, as the model axis's
  are (a product cut to half its columns is printed beside them);
- on 2 spawned gloo ranks over (data 1, model 2), ``tp_dp`` for the
  gradients (gathered) and ``tp_sp`` for serving.

Prints, for each way, the worst leaf's largest gradient difference from
the baseline over that leaf's largest entry (the measure of
``chip_smoke.py``'s ``_tp_rel``), and the logits' largest difference
over the largest logit (``_tp_check``), prefill and decode steps
together.

Run from the root of a checkout:
  PYTHONPATH=src python scripts/tp_spread.py --d-model 640
  PYTHONPATH=src python scripts/tp_spread.py --device cuda --d-model 0
(the first ~2 minutes on 8 CPU cores; the second needs one GPU of 40 GB)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0 ** -24


def _cfg(d_model: int):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("zamba2_2p7b"), n_layers=6,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    if d_model:
        cfg = dataclasses.replace(
            cfg, d_model=d_model, n_heads=8, n_kv_heads=8,
            head_dim=d_model // 8, d_ff=4 * d_model, vocab_size=4000)
    return cfg


def _seeded(cfg, dev: str):
    from repro_torch.models.archs import build_model

    return build_model(cfg, remat="none", device=dev).init(
        torch.Generator(device=dev).manual_seed(0))


def _inputs(cfg) -> tuple:
    """(the first train batch, the prompts) of ``chip_smoke.py``'s phase
    26 (a) at its seed 0, in ``cfg``'s vocabulary, unpacked on the
    host."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    C.DEVICE = "cpu"
    P = C._load_port()
    store = P.core.make_store(8, replicas=2)
    try:
        vol = P.core.GlobalVOL(store)
        P.corpus.build_corpus(vol, P.corpus.CorpusSpec(
            n_seqs=C.FS_CORPUS_SEQS, seq_len=C.TRAIN_SEQ,
            vocab_size=cfg.vocab_size, seed=0), chunk_rows=C.FS_CORPUS_SEQS)
        words = C._fs_batches(P, vol, 0, 0, 1, dp_size=1)[0]
    finally:
        store.close()
    batch = P.ingest.fused_batch(words[:C.TP_F32_BATCH,
                                       :C.TP_F32_SEQ // 32])
    prompts = P.ingest.fused_batch(
        words[:C.TP_SERVE_BATCH, :C.TP_SERVE_SEQ // 32])["tokens"]
    return batch, prompts, C.TP_DECODE


def _on(dev: str, batch: dict, prompts) -> tuple:
    return {k: v.to(dev) for k, v in batch.items()}, prompts.to(dev)


def _grads(model, batch) -> dict:
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


@torch.no_grad()
def _serve(model, prompts, steps: int) -> list:
    logits, cache = model.prefill({"tokens": prompts},
                                  max_seq=prompts.shape[1] + steps)
    outs = [logits]
    for _ in range(steps):
        logits, cache = model.decode_step(
            logits.argmax(-1, keepdim=True).int(), cache)
        outs.append(logits)
    return outs


def _one_device(cfg, inputs: tuple, dev: str, seed: int | None) -> tuple:
    """(gradients, logits) on one device; with ``seed`` every split
    layer's output changed in its last bits."""
    from repro_torch.models import layers, recurrent, ssm

    combine = layers.tp_combine
    if seed is not None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def combine(out, tp, seq_group):
            noise = torch.randn(out.shape, generator=gen, device=out.device,
                                dtype=out.dtype)
            return layers.tp_combine(out, tp, seq_group) * (1 + ULP * noise)
    saved = ssm.tp_combine, recurrent.tp_combine
    ssm.tp_combine = recurrent.tp_combine = combine
    try:
        batch, prompts = _on(dev, *inputs[:2])
        model = _seeded(cfg, dev)
        return _grads(model, batch), _serve(model, prompts, inputs[2])
    finally:
        ssm.tp_combine, recurrent.tp_combine = saved


def _one_at_a_time(cfg, inputs: tuple, dev: str) -> list:
    """The logits of serving each prompt alone, stacked."""
    model = _seeded(cfg, dev)
    prompts = inputs[1].to(dev)
    each = [_serve(model, prompts[i:i + 1], inputs[2])
            for i in range(prompts.shape[0])]
    return [torch.cat(step) for step in zip(*each)]


def _rank(rank: int, world: int, init: str, tmp: str, d_model: int,
          dev: str):
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import steps

    if dev == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        cfg = _cfg(d_model)
        mesh = lmesh.make_smoke_mesh((1, world), ("data", "model"), dev)
        train = shd.MeshRules(mesh, strategy="tp_dp")
        batch, prompts, decode = torch.load(Path(tmp) / "inputs.pt")
        batch, prompts = _on(dev, batch, prompts)
        model = _seeded(cfg, dev)
        steps.shard_params(model, train)
        specs = steps.param_specs(model)
        params = dict(model.named_parameters())
        with shd.use_rules(train):
            grads = _grads(model, batch)
            whole = {n: shd.gather_whole(g, shd.fitted(
                train, specs[n], params[n].fsdp_shape), train)
                for n, g in grads.items()}
        del model, params, grads
        serve = shd.MeshRules(mesh, strategy="tp_sp")
        model = _seeded(cfg, dev)
        steps.shard_params(model, serve)
        with shd.use_rules(serve):
            logits = _serve(model, prompts, decode)
        if rank == 0:
            torch.save({"grads": whole, "logits": logits},
                       Path(tmp) / "tp.pt")
    finally:
        dist.destroy_process_group()


def _spread(base: tuple, other: tuple) -> dict:
    (g0, l0), (g, lg) = base, other
    worst, at = None, None
    for n, w in (g0.items() if g is not None else ()):
        rel = float((g[n] - w).abs().max()) / max(float(w.abs().max()),
                                                  1e-30)
        if worst is None or rel >= worst:
            worst, at = rel, n
    top = max(float(x.abs().max()) for x in l0)
    steps = [float((a - b).abs().max()) / top for a, b in zip(lg, l0)]
    return {"grad_rel": worst, "leaf": at, "logit_rel": max(steps),
            "tokens_equal": all(torch.equal(a.argmax(-1), b.argmax(-1))
                                for a, b in zip(lg, l0)),
            "logit_rel_by_step": [float(f"{e:.3g}") for e in steps]}


@torch.no_grad()
def _split_products(cfg, inputs: tuple, dev: str) -> dict:
    """How far a product cut to half its columns, as a rank of the model
    axis computes it, lies from the same columns of the whole product on
    this device, over the whole product's largest entry: the first
    Mamba2 layer's ``wz`` on the prompts' embeddings, and the head on
    their last positions."""
    model = _seeded(cfg, dev)
    x = model.embed["tok"][inputs[1].to(dev)]
    wz, head = model.mamba[0][0].mamba["wz"], model.embed["head"]
    out = {}
    for name, a, w, eq, dim in (("wz", x, wz, "bsd,dhp->bshp", 2),
                                ("head", x[:, -1], head, "bd,dv->bv", 1)):
        whole = torch.einsum(eq, a, w)
        h = w.shape[1] // 2
        half = torch.einsum(eq, a, w[:, :h].contiguous())
        out[name] = float((half - whole.narrow(dim, 0, h)).abs().max()
                          / whole.abs().max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=640,
                    help="0: the published widths")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(4)
    cfg = _cfg(args.d_model)
    inputs = _inputs(cfg)
    base = _one_device(cfg, inputs, args.device, None)
    rows = {}
    for s in range(args.seeds):
        rows[f"last bits, seed {s}"] = _spread(
            base, _one_device(cfg, inputs, args.device, s))
        if args.device == "cuda":
            torch.cuda.empty_cache()
    rows["one prompt at a time"] = _spread(
        base, (None, _one_at_a_time(cfg, inputs, args.device)))
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, Path(d) / "inputs.pt")
        torch.multiprocessing.spawn(
            _rank, args=(2, f"file://{d}/pg", d, args.d_model, args.device),
            nprocs=2)
        tp = torch.load(Path(d) / "tp.pt", map_location=args.device)
    rows["model axis of 2"] = _spread(base, (tp["grads"], tp["logits"]))
    split = _split_products(cfg, inputs, args.device)
    batch, prompts, decode = inputs
    print(f"zamba2_2p7b, one group at d_model {cfg.d_model} on "
          f"{args.device}: gradients of {list(batch['tokens'].shape)} "
          f"tokens, logits of {list(prompts.shape)} prompts and {decode} "
          f"decode steps; largest difference from one device over the "
          f"leaf's largest gradient entry / the largest logit")
    for k, r in rows.items():
        print(f"  {k}: {json.dumps(r)}")
    print("a half-column product against the whole one's columns: "
          + json.dumps(split))
    one = [r for k, r in rows.items() if k != "model axis of 2"]
    print("worst on one device: " + json.dumps(
        {"grad_rel": max(r["grad_rel"] for r in one
                         if r["grad_rel"] is not None),
         "logit_rel": max(r["logit_rel"] for r in one)}))


if __name__ == "__main__":
    sys.exit(main())
