"""Serving in a closed loop: ``clients`` editors, each waiting for its
reply before it sends again, through the program's ``ServeEngine``.

The requests, drawn from the run's seed: each prompt's length uniform
on [``prompt.min``, ``prompt.max``], its completion length
(``max_new``) uniform on [``max_new.min``, ``max_new.max``], every
token id uniform on [1, vocab).  A mix whose ranges are single values
(a benchmark's fixed budgets) gives every seed the same work.  Decoding
is greedy with no end-of-sequence token, so every request gets its
``max_new`` tokens.

Since every client waits for its reply, a batch is the next request of
each client: the engine left-pads them with token 0 to the longest
prompt, prefills and decodes them together, and every request of the
batch completes when ``generate`` returns.  The program's prefill
attends in blocks of ``pad_multiple`` positions, so the benchmark
left-pads the longest prompt with the engine's own pad token up to a
multiple of it: the engine then pads the others as it does.  A
request's latency runs from its send (the start of that ``generate``)
to that return.  Where the configuration states a ``sliding_window``,
every padded prompt with its completion has to fit inside it (the
program attends to the whole prefix).

Set-up: the program's model whole at the configuration's sizes, its
weights drawn from the seed; the engine; one ``generate`` at the
longest padded shape with two new tokens, which warms up the prefill
at that length and the decode against the engine's cache.
The window: whole batches, until ``--seconds`` have passed.

The check, once the window has closed, the peak memory read and the
program's state freed: a sample of ``check_requests`` finished requests
drawn from the seed, the one with the most tokens always in it; the
reference runs each padded prompt and its served tokens once
(``reference.lm.logits_at``), and each served token's logit is held
against the reference's best (``reference.compare.served_gap``).
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.harness import now
from perfbench.reference import compare, lm


def padded_to(traffic: dict, n: int) -> int:
    """The length a batch whose longest prompt has ``n`` tokens is
    prefilled at."""
    mult = traffic["pad_multiple"]
    return -(-n // mult) * mult


def max_seq(traffic: dict) -> int:
    """The engine's cache length: the longest padded prompt and the
    longest completion."""
    return padded_to(traffic, traffic["prompt"]["max"]) + \
        traffic["max_new"]["max"]


class Requests:
    """The seed's stream of batches: one request of each client."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic = traffic
        self.vocab = vocab
        self.rng = np.random.default_rng([seed, 2])

    def batch(self) -> list[tuple[np.ndarray, int]]:
        p, m = self.traffic["prompt"], self.traffic["max_new"]
        n = self.traffic["clients"]
        lens = self.rng.integers(p["min"], p["max"] + 1, n)
        new = self.rng.integers(m["min"], m["max"] + 1, n)
        return [(self.rng.integers(1, self.vocab, k).astype(np.int32),
                 int(j)) for k, j in zip(lens, new)]


def to_engine(traffic: dict, batch: list) -> tuple[list, int]:
    """The prompts as the engine is handed them (the longest left-padded
    with token 0 to its block multiple) and the padded length."""
    S = padded_to(traffic, max(len(p) for p, _ in batch))
    prompts = [p for p, _ in batch]
    top = max(range(len(batch)), key=lambda i: len(batch[i][0]))
    prompts[top] = np.concatenate([np.zeros(S - len(prompts[top]),
                                            np.int32), prompts[top]])
    return prompts, S


def _synced(fn, name: str, spans: list, dev: str):
    """``fn`` timed into ``spans``, the card synchronised before the
    clock stops."""
    def run(*args):
        t = now()
        out = fn(*args)
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        spans.append((name, t, now()))
        return out
    return run


def run(ctx: harness.Context, cell: harness.Cell):
    P = harness.port_modules(ctx.root)
    cfg, traffic, dev = cell.config, cell.traffic, ctx.device
    spec = lm.spec_from_config(cfg)
    layout = lm.param_layout(spec)
    arch = harness.port_config(P, cfg)
    res = harness.Run(spec=spec, traffic=traffic)
    eng_mod = P["engine"]

    marks = [("imports", now())]
    model = P["archs"].build_model(arch, remat="none", device=dev)
    weights.load_into(model, layout, ctx.seed)
    marks.append(("model and weights", now()))
    window = cfg.get("sliding_window")
    if window and max_seq(traffic) > window:
        raise SystemExit(
            f"perfbench: a padded prompt with its completion reaches "
            f"{max_seq(traffic)} positions, past the configuration's "
            f"{window}-token sliding window, which the program does not "
            "apply")
    engine = eng_mod.ServeEngine(model, max_seq=max_seq(traffic))
    reqs = Requests(traffic, spec.vocab, ctx.seed)
    warm = np.random.default_rng([ctx.seed, 3])
    S = padded_to(traffic, traffic["prompt"]["max"])
    engine.generate([eng_mod.Request(
        prompt=warm.integers(1, spec.vocab, S).astype(np.int32), max_new=2)
        for _ in range(traffic["clients"])])
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
    res.setup_s = now() - ctx.t0
    marks.append(("warm-up", now()))
    harness.log_setup(ctx, marks)

    calls: list = []          # the logits each engine call returned
    for name in ("_prefill", "_decode"):
        setattr(engine, name, _keeping(getattr(engine, name), calls))
    tracer = None
    if ctx.trace:
        for name in ("_prefill", "_pad_cache", "_decode"):
            setattr(engine, name, _synced(getattr(engine, name),
                                          "engine." + name.strip("_"),
                                          res.spans, dev))
        if dev.startswith("cuda"):
            from perfbench.trace import Tracer
            tracer = Tracer()
    served, logits = [], []
    stopped = False
    start = now()
    if tracer:
        tracer.start()
    while True:
        batch = reqs.batch()
        prompts, S = to_engine(traffic, batch)
        calls.clear()
        t = now()
        comps = engine.generate([eng_mod.Request(prompt=p, max_new=n)
                                 for p, (_, n) in zip(prompts, batch)])
        done = now()
        res.spans.append(("engine.generate", t, done))
        res.batches.append({"batch": len(batch), "padded": S,
                            "wall_s": done - t})
        logits.append(list(calls))
        for slot, ((p, n), c) in enumerate(zip(batch, comps)):
            res.requests.append({"sent": t, "done": done, "max_new": n,
                                 "served": len(c.tokens),
                                 "prompt_len": len(p)})
            served.append(Served(p, S - len(p), np.asarray(c.tokens), n,
                                 len(logits) - 1, slot))
        if tracer and not stopped and \
                len(res.batches) == traffic["trace_batches"]:
            tracer.stop()
            stopped = True
        if now() - start >= ctx.seconds:
            break
    res.window = (start, now())
    if tracer:
        if not stopped:
            tracer.stop()
        res.trace = tracer.summary(res.spans)
    res.attempted = len(res.requests)
    res.failed = sum(r["served"] != r["max_new"] for r in res.requests)
    if dev.startswith("cuda"):
        res.memory_peak_bytes = torch.cuda.max_memory_allocated()
    ctx.log(f"serve: {len(res.batches)} batches, {res.attempted} requests "
            f"in {res.window_s:.2f} s; padded lengths "
            f"{[b['padded'] for b in res.batches]}")

    not_greedy = 0
    for r in served:
        first = torch.stack([logits[r.batch][t][r.slot]
                             for t in range(len(r.tokens))]).argmax(-1)
        not_greedy += int((first.cpu().numpy() != r.tokens).sum())
    idx = sample(served, traffic["check_requests"], ctx.seed)
    for i in idx:
        r = served[i]
        r.logits = torch.stack([logits[r.batch][t][r.slot]
                                for t in range(len(r.tokens))]).cpu()
    del engine, model, logits, calls
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    out = readings(ctx, spec, layout, served, idx)
    out["served_not_greedy"] = float(not_greedy)
    return res, out


@dataclasses.dataclass
class Served:
    """A finished request: its prompt, the pad in front of it in its
    batch, the tokens served, the tokens asked for, and where the
    engine's logits of its tokens are (batch, slot); ``logits`` (n, V)
    is filled for the sampled requests."""

    prompt: np.ndarray
    pad: int
    tokens: np.ndarray
    max_new: int
    batch: int
    slot: int
    logits: torch.Tensor | None = None

    @property
    def length(self) -> int:
        return self.pad + len(self.prompt) + len(self.tokens)


def _keeping(fn, calls: list):
    """``fn`` (the engine's prefill or decode), each call's logits kept:
    the program's output at every served position."""
    def run(*args):
        out = fn(*args)
        calls.append(out[0])
        return out
    return run


def sample(served: list, k: int, seed: int) -> list[int]:
    """``k`` indices of ``served`` drawn from the seed, the request with
    the most tokens (prompt, pad and served) always among them."""
    longest = max(range(len(served)), key=lambda i: served[i].length)
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[i] for i in pick)


def reference_readings(ctx, spec, layout, served, idx, other=None) -> dict:
    """Over the sampled requests, each padded prompt and its served
    tokens run once through the float32 reference: the widest gap of a
    served token's logit below the reference's best, and the largest
    relative error ||logits - reference|| / ||reference|| of a served
    position.  With ``other`` (the control's numerics), its logits and
    first choices at the same positions stand in for the program's."""
    params = weights.draw(layout, ctx.seed, ctx.device)
    gap = err = 0.0
    for i in idx:
        r = served[i]
        seq = np.concatenate([np.zeros(r.pad, np.int32), r.prompt,
                              r.tokens[:-1].astype(np.int32)])
        seq_t = torch.from_numpy(seq).to(ctx.device)
        where = torch.arange(r.pad + len(r.prompt) - 1, len(seq),
                             device=ctx.device)
        ref = lm.logits_at(spec, params, seq_t, where).cpu()
        got, pick = r.logits, r.tokens
        if other is not None:
            got = lm.logits_at(spec, params, seq_t, where, other).cpu()
            pick = got.argmax(-1).numpy()
        gap = max(gap, compare.served_gap(ref.numpy(), pick))
        err = max(err, compare.logit_error(got, ref))
    return {"served_logit_gap": gap, "served_logit_err": err}


def readings(ctx, spec, layout, served, idx) -> dict:
    bad = sum(len(r.tokens) != r.max_new or (len(r.tokens) and (
        r.tokens.min() < 0 or r.tokens.max() >= spec.vocab)) for r in served)
    out = {"requests_bad": float(bad)}
    if not served:
        return out
    t = now()
    out.update(reference_readings(ctx, spec, layout, served, idx))
    ctx.log(f"reference: {len(idx)} requests, "
            f"{sum(len(served[i].tokens) for i in idx)} served tokens in "
            f"{now() - t:.1f} s; {out}")
    return out
