"""Training from the object store: packed token sequences read through
the program's loader into its ``Trainer``, step after step.

Set-up: the program's model at the configuration's sizes, its weights
drawn from the seed (``perfbench.weights``); a corpus of
``corpus_seqs`` x ``seq_len`` token ids drawn uniformly over the
vocabulary from the seed, written in one call through the program's
write path into a fresh store of ``osds`` OSDs and ``replicas``
replicas (the store picks the planar bitpack width of the ids); a packed,
prefetching ``ObjectDataLoader`` feeding a ``Trainer`` with packed
ingest.  The Trainer then runs its first ``check_steps`` steps, through
``Trainer.run``, one call a step: they warm up every shape and are the
steps the reference follows.

The window: more steps through the same ``Trainer.run``, back to back,
until ``--seconds`` have passed; it ends at a step boundary (each step
ends with the Trainer's one host sync).  No checkpoint is written.

The check, once the window has closed, the peak memory read and the
program's state freed: the packed words of the first steps, decoded by
the reference, must be distinct rows of the corpus; the reference
trains its own copy of the same weights on those rows for the same
steps, and each step's loss, each leaf's gradient norm as the optimizer
took it (from the program's first moments after step one), and each
leaf's change over the steps are compared (``reference.compare``).
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.harness import now
from perfbench.reference import compare, lm


class Feed:
    """The loader as the Trainer sees it, with the benchmark's timer
    around each ``next`` and a copy of the first ``keep`` batches'
    packed words."""

    def __init__(self, loader, spans: list, keep: int):
        self.loader, self.spans, self.keep = loader, spans, keep
        self.kept: list[np.ndarray] = []

    def __next__(self):
        t = now()
        batch = next(self.loader)
        self.spans.append(("loader.next", t, now()))
        if len(self.kept) < self.keep:
            self.kept.append(np.array(batch["tokens_packed"], copy=True))
        return batch

    def __iter__(self):
        return self

    def __getattr__(self, name):
        return getattr(self.loader, name)


def corpus_tokens(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (traffic["corpus_seqs"],
                                   traffic["seq_len"])).astype(np.int32)


def build_store(P: dict, traffic: dict, toks: np.ndarray, seed: int):
    """A fresh store holding the corpus (``CorpusSpec``'s schema: tokens,
    doc_id, quality), written in one call."""
    n, S = toks.shape
    store = P["core"].make_store(traffic["osds"],
                                 replicas=traffic["replicas"])
    vol = P["core"].GlobalVOL(store)
    ds = P["corpus"].CorpusSpec(n_seqs=n, seq_len=S,
                                vocab_size=int(toks.max()) + 1).dataset()
    omap = vol.create(ds, P["PartitionPolicy"](
        target_object_bytes=traffic["object_bytes"],
        max_object_bytes=traffic["max_object_bytes"]))
    rng = np.random.default_rng([seed, 1])
    vol.write(omap, {"tokens": toks,
                     "doc_id": rng.integers(0, max(n // 16, 1),
                                            n).astype(np.int32),
                     "quality": rng.beta(4, 2, n).astype(np.float32)})
    return store, vol, ds.name


@torch.no_grad()
def first_gradient(out: dict, m: dict, beta1: float, probe: dict) -> None:
    """The first gradient as the optimizer took it (clipped), from the
    first moments after one step (m = (1 - beta1) g): each leaf's norm,
    and its entries at ``probe``."""
    out["grad_norms"] = {n: float(t.float().norm()) / (1 - beta1)
                         for n, t in m.items()}
    out["grad_samples"] = {n: t.reshape(-1)[probe[n].to(t.device)].float()
                           .cpu() / (1 - beta1) for n, t in m.items()}


@torch.no_grad()
def leaf_change(out: dict, params: dict, p0: dict, probe: dict) -> None:
    """Each leaf's change from ``p0``, in float32: its norm, and its
    entries at ``probe``."""
    out["change"], out["change_samples"] = {}, {}
    for n, p in params.items():
        d = p.float() - p0[n].float()
        out["change"][n] = float(d.norm())
        out["change_samples"][n] = d.reshape(-1)[probe[n].to(d.device)].cpu()


def opt_config(P: dict, a: dict):
    return P["optimizer"].OptConfig(
        lr=a["lr"], betas=tuple(a["betas"]), eps=a["eps"],
        weight_decay=a["weight_decay"], clip_norm=a["clip_norm"],
        warmup_steps=a["warmup_steps"], total_steps=a["total_steps"],
        min_lr_frac=a["min_lr_frac"])


def run(ctx: harness.Context, cell: harness.Cell):
    P = harness.port_modules(ctx.root)
    cfg, traffic, dev = cell.config, cell.traffic, ctx.device
    spec = lm.spec_from_config(cfg)
    layout = lm.param_layout(spec)
    arch = harness.port_config(P, cfg)
    P["fmt"].set_bitunpack_backend("device" if dev.startswith("cuda")
                                   else "plain")
    B, S, n_check = traffic["batch"], traffic["seq_len"], \
        traffic["check_steps"]
    res = harness.Run(spec=spec, traffic=traffic)

    marks = [("imports", now())]
    model = P["archs"].build_model(arch, remat=cfg["port"]["remat"],
                                   device=dev)
    weights.load_into(model, layout, ctx.seed)
    marks.append(("model and weights", now()))
    toks = corpus_tokens(traffic, spec.vocab, ctx.seed)
    store, vol, name = build_store(P, traffic, toks, ctx.seed)
    marks.append(("corpus write", now()))
    loader = P["pipeline"].ObjectDataLoader(
        vol, name, global_batch=B, seed=ctx.seed, packed=True,
        prefetch=traffic["prefetch"])
    feed = Feed(loader, res.spans, n_check)
    opt = opt_config(P, cell.optimizer)
    tcfg = P["trainer"].TrainerConfig(total_steps=0, ckpt_every=1 << 40,
                                      log_every=1 << 40, packed_ingest=True)
    tr = P["trainer"].Trainer(model, feed, store, opt=opt, cfg=tcfg,
                              log=ctx.log)
    step_fn = tr.train_step

    def timed_step(state, batch):
        t = now()
        out = step_fn(state, batch)
        res.spans.append(("train_step", t, now()))
        return out
    tr.train_step = timed_step
    params = dict(model.named_parameters())
    state = {"params": params,
             "opt": P["optimizer"].init_opt_state(params, arch.opt_dtype)}

    def one_step(k: int):
        tcfg.total_steps = k + 1
        out = tr.run(state, start_step=k)
        res.spans.append(("metrics.sync", res.spans[-1][2], now()))
        return out

    probe = compare.probes(layout)
    prog = {}
    for k in range(n_check):
        state = one_step(k)
        if k == 0:
            first_gradient(prog, state["opt"]["m"], opt.betas[0], probe)
    marks.append((f"{n_check} steps", now()))
    leaf_change(prog, params, weights.draw(layout, ctx.seed, dev), probe)
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
    res.setup_s = now() - ctx.t0
    marks.append(("the change's norms", now()))
    harness.log_setup(ctx, marks)
    res.spans.clear()

    tracer = None
    if ctx.trace and dev.startswith("cuda"):
        from perfbench.trace import Tracer
        tracer = Tracer()
    k = n_check
    start = now()
    if tracer:
        tracer.start()
    while True:
        state = one_step(k)
        k += 1
        if tracer and k - n_check == traffic["trace_steps"]:
            tracer.stop()
        if now() - start >= ctx.seconds:
            break
    res.window = (start, now())
    if tracer and k - n_check < traffic["trace_steps"]:
        tracer.stop()
    hist = tr.history
    res.steps = [{"tokens": B * S, "wall_s": h["wall_s"], "loss": h["loss"]}
                 for h in hist[n_check:]]
    res.attempted = len(res.steps)
    res.failed = sum(not math.isfinite(h["loss"]) for h in hist[n_check:])
    if dev.startswith("cuda"):
        res.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if tracer:
        res.trace = tracer.summary(res.spans)
    prog["losses"] = [h["loss"] for h in hist[:n_check]]
    ctx.log(f"train: {k - n_check} window steps, losses "
            f"{[round(h['loss'], 4) for h in hist]}")

    loader.close()
    store.close()
    words = feed.kept
    del tr, state, params, model, feed, loader, step_fn
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    return res, readings(ctx, cell, spec, layout, toks, words, prog, probe)


def reference_steps(ctx, cell, spec, layout, rows, probe, num=None):
    """The reference's numbers over ``len(rows)`` steps from the seed's
    weights on the corpus rows ``rows`` (a list of (B, S) int arrays):
    as ``first_gradient`` and ``leaf_change`` give the program's."""
    dev = ctx.device
    params = weights.draw(layout, ctx.seed, dev)
    rt = lm.Trainer(spec, params, lm.opt_from(cell.optimizer), num=num)
    out = {"losses": []}
    for k, r in enumerate(rows):
        step = rt.step(torch.from_numpy(np.asarray(r)).to(dev),
                       probe if k == 0 else None)
        out["losses"].append(step["loss"])
        if k == 0:
            out["grad_norms"] = step["leaf_grad_norms"]
            out["grad_samples"] = step["leaf_grad_samples"]
    del rt
    gc.collect()
    leaf_change(out, params, weights.draw(layout, ctx.seed, dev), probe)
    return out


def readings(ctx, cell, spec, layout, toks, words, prog, probe) -> dict:
    """The rows the first steps consumed, looked up in the corpus; then,
    where every one is a distinct corpus row, the reference on those
    rows and the program's numbers against it (``compare_steps``)."""
    bits = words[0].shape[-1]
    rows, bad = [], 0
    for w in words:
        b, idx = compare.match_rows(compare.bitpack_decode(w, bits), toks)
        bad += b
        rows.append(toks[idx])
    if bad:
        return {"rows_bad": float(bad)}
    t = now()
    ref = reference_steps(ctx, cell, spec, layout, rows, probe)
    ctx.log(f"reference: {len(rows)} steps in {now() - t:.1f} s, losses "
            f"{[round(x, 4) for x in ref['losses']]} (program "
            f"{[round(x, 4) for x in prog['losses']]})")
    return dict(rows_bad=0.0, **compare_steps(prog, ref, ctx.log))


def compare_steps(prog: dict, ref: dict, log=lambda m: None) -> dict:
    """Each step's loss, the worst leaf's gradient norm and change
    (gaps of norms), and the worst leaf's gradient and change at the
    sampled entries (norms of the difference); a leaf whose reference
    gradient is under a thousandth of the median leaf's is left out of
    the changes."""
    out = {f"loss_gap.step{k + 1}": compare.rel_gap(a, b)
           for k, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    moving = compare.moving_leaves(ref["grad_norms"])
    worst = {}
    for name, fn, key, leaves in (
            ("grad_norm_gap", compare.leaf_gap, "grad_norms", None),
            ("change_gap", compare.leaf_gap, "change", moving),
            ("grad_diff_gap", compare.diff_gap, "grad_samples", None),
            ("change_diff_gap", compare.diff_gap, "change_samples", moving)):
        out[name], worst[name] = fn(prog[key], ref[key], leaves)
    log(f"worst leaves: {worst}; {len(ref['grad_norms']) - len(moving)} "
        f"leaves left out of the changes")
    return out
