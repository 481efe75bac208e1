"""The comparison that decides ``correct`` must fail what it guards
against, at the smoke sizes on the CPU: the control (the reference in
float8, the precision below the configurations' bfloat16, put in the
program's place) and the faults a cell can have, each planted in the
program underneath a run that the harness otherwise drives in full.
The one fault a one-chip cell cannot have, an exchange between chips
left out, has no test."""

import importlib
import json

import numpy as np
import pytest
import torch

from perfbench import harness, smoke
from perfbench.kinds import serve_closed, train_packed
from perfbench.reference import compare, lm

PORT = harness.port_modules(smoke.REPO)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    PORT["fmt"].set_bitunpack_backend("plain")
    return smoke.make_copy(tmp_path_factory.mktemp("pb"))


def limits(copy, cell):
    return json.loads((copy / "perfbench" / "cells" / f"{cell}.json")
                      .read_text())["limits"]


def failed(line) -> list[str]:
    """The numbers out of their limits, or not read at all."""
    return [n for n, c in line["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]]


def test_train_control_fails(copy):
    """The reference in float8 for the program, against the float32
    reference: three steps of each on the same rows."""
    cell = harness.find_cell(copy, smoke.TRAIN_CELL)
    ctx = harness.Context(root=copy, workload=cell.name, seed=21, seconds=0,
                          trace=False, device="cpu", t0=0.0)
    spec = lm.spec_from_config(cell.config)
    layout = lm.param_layout(spec)
    toks = train_packed.corpus_tokens(cell.traffic, spec.vocab, 21)
    rows = [toks[4 * k:4 * k + 4] for k in range(3)]
    probe = compare.probes(layout)
    ref = train_packed.reference_steps(ctx, cell, spec, layout, rows, probe)
    ctl = train_packed.reference_steps(ctx, cell, spec, layout, rows, probe,
                                       num=lm.Numerics(fp8=True))
    out = train_packed.compare_steps(ctl, ref)
    lim = limits(copy, smoke.TRAIN_CELL)
    assert [n for n, v in out.items() if n in lim and v > lim[n]]


def test_serve_control_fails(copy):
    """At each served position of the same prompts and tokens, the token
    the float8 reference ranks first, held against the float32 one."""
    cell = harness.find_cell(copy, smoke.SERVE_CELL)
    ctx = harness.Context(root=copy, workload=cell.name, seed=22, seconds=0,
                          trace=False, device="cpu", t0=0.0)
    spec = lm.spec_from_config(cell.config)
    rng = np.random.default_rng(22)
    served = [serve_closed.Served(rng.integers(1, spec.vocab, 40).astype(
        np.int32), 8, rng.integers(1, spec.vocab, 6), 6, 0, 0)
        for _ in range(4)]
    out = serve_closed.reference_readings(
        ctx, spec, lm.param_layout(spec), served, range(4),
        other=lm.Numerics(fp8=True))
    lim = limits(copy, smoke.SERVE_CELL)
    assert [n for n, v in out.items() if n in lim and v > lim[n]]


def test_a_step_that_leaves_the_state_unchanged_fails(copy, monkeypatch):
    steps = importlib.import_module("repro_torch.train.steps")

    def no_update(cfg, grads, params, opt_state, decay=None):
        return params, opt_state, torch.zeros(())
    monkeypatch.setattr(steps, "adamw_update", no_update)
    line = smoke.run(copy, smoke.TRAIN_CELL, seed=23)
    assert not line["correct"]
    assert "change_gap" in failed(line)


def test_half_the_batch_left_out_fails(copy, monkeypatch):
    fused = importlib.import_module("repro_torch.data.fused_ingest")
    whole = fused.fused_batch
    monkeypatch.setattr(fused, "fused_batch",
                        lambda packed: whole(packed[:packed.shape[0] // 2]))
    line = smoke.run(copy, smoke.TRAIN_CELL, seed=24)
    assert not line["correct"]
    assert "grad_diff_gap" in failed(line)


def test_a_served_token_altered_fails(copy, monkeypatch):
    eng = PORT["engine"].ServeEngine
    pick = eng._pick

    def altered(self, logits):
        tok = pick(self, logits)
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(eng, "_pick", altered)
    line = smoke.run(copy, smoke.SERVE_CELL, seed=25)
    assert not line["correct"]
    assert "served_not_greedy" in failed(line)


def test_a_corrupted_store_read_fails(copy, monkeypatch):
    """The loader hands the first step one flipped bit of a row."""
    loader = PORT["pipeline"].ObjectDataLoader
    nxt = loader.__next__

    def corrupt(self):
        batch = nxt(self)
        if self.state.step == 1:
            batch["tokens_packed"][0, 0, 0] ^= 1
        return batch
    monkeypatch.setattr(loader, "__next__", corrupt)
    line = smoke.run(copy, smoke.TRAIN_CELL, seed=26)
    assert not line["correct"]
    assert line["checks"]["rows_bad"]["value"] == 1


def test_the_longest_prompt_is_padded_to_the_block_with_the_pad_token():
    traffic = {"pad_multiple": 8}
    batch = [(np.arange(1, 6, dtype=np.int32), 2),
             (np.arange(1, 12, dtype=np.int32), 3)]
    prompts, S = serve_closed.to_engine(traffic, batch)
    assert S == 16 and len(prompts[1]) == 16 and len(prompts[0]) == 5
    assert not prompts[1][:5].any() and (prompts[1][5:] == batch[1][0]).all()


def test_traffic_past_the_sliding_window_is_refused(tmp_path):
    root = smoke.make_copy(tmp_path)
    path = root / "perfbench" / "configs" / "sc2_smoke.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, sliding_window=32)))
    with pytest.raises(SystemExit, match="sliding window"):
        smoke.run(root, smoke.SERVE_CELL, seed=27)
