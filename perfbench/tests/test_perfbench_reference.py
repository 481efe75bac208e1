"""The plain reference held against the program at the configured
models' smoke sizes (float32, on the CPU): the smoke cells' checks, each
gradient leaf of one step, and the prefill's logits."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench import harness, smoke, weights
from perfbench.reference import lm

PORT = harness.port_modules(smoke.REPO)
TOL = 1e-5


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    PORT["fmt"].set_bitunpack_backend("plain")
    return smoke.make_copy(tmp_path_factory.mktemp("pb"))


@pytest.fixture(scope="module")
def train_line(copy):
    return smoke.run(copy, smoke.TRAIN_CELL, seed=11)


@pytest.fixture(scope="module")
def serve_line(copy):
    return smoke.run(copy, smoke.SERVE_CELL, seed=12)


@pytest.mark.parametrize("name", ["rows_bad", "grad_norm_gap", "change_gap",
                                  "grad_diff_gap"])
def test_train_cell_agrees(train_line, name):
    assert train_line["checks"][name]["value"] <= TOL
    assert train_line["correct"]


def test_serve_cell_agrees(serve_line):
    assert serve_line["checks"]["served_logit_err"]["value"] <= TOL
    assert serve_line["checks"]["requests_bad"]["value"] == 0
    assert serve_line["checks"]["served_not_greedy"]["value"] == 0
    assert serve_line["correct"]


def _model(cfg: dict, seed: int):
    spec = lm.spec_from_config(cfg)
    layout = lm.param_layout(spec)
    arch = harness.port_config(PORT, cfg)
    model = PORT["archs"].build_model(arch, remat="none", device="cpu")
    weights.load_into(model, layout, seed)
    return spec, layout, model


@pytest.fixture(scope="module")
def grads():
    """One step's gradient of every leaf: the program's (autograd of its
    loss) and the reference's (its layer-by-layer backward)."""
    spec, layout, model = _model(smoke.DSV2, 3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, spec.vocab, (2, 64))).to(torch.int32)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    loss, _ = model.loss({"tokens": toks, "labels": labels})
    params = dict(model.named_parameters())
    prog = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    rt = lm.Trainer(spec, weights.draw(layout, 3, "cpu"), lm.Opt(1e-3, 2, 10))
    ref = {}
    xs = [lm.embed(rt.params, toks)]
    pos = torch.arange(64).expand(2, -1)
    with torch.no_grad():
        for p, is_moe in lm.layer_prefixes(spec):
            xs.append(lm.block(spec, rt.num, lm.layer_weights(rt.params, p),
                               p, is_moe, xs[-1], pos)[0])
    rt._backward(xs, toks, labels, float((labels >= 0).sum()),
                 lambda n, g: ref.__setitem__(n, g.detach().clone()))
    return prog, ref


LEAVES = [leaf.name for leaf in lm.param_layout(lm.spec_from_config(smoke.DSV2))]


@pytest.mark.parametrize("leaf", LEAVES)
def test_each_gradient_leaf_agrees(grads, leaf):
    prog, ref = grads
    scale = max(float(ref[leaf].abs().max()), 1e-12)
    assert float((prog[leaf].float() - ref[leaf]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("cfg", [smoke.DSV2, smoke.SC2],
                         ids=lambda c: c["name"])
def test_prefill_logits_agree(cfg):
    spec, layout, model = _model(cfg, 4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, spec.vocab, (1, 48))).to(torch.int32)
    with torch.inference_mode():
        got, _ = model.prefill({"tokens": toks})
    want = lm.logits_at(spec, weights.draw(layout, 4, "cpu"), toks[0],
                        torch.tensor([47]))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_capacity_drops_tokens_at_the_smoke_size():
    """The smoke cell routes with the configured capacity factor 1.25:
    some entries are dropped, so the check covers the drop."""
    spec = lm.spec_from_config(smoke.DSV2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, spec.d_model, generator=gen)
    router = torch.randn(spec.d_model, spec.n_routed, generator=gen) * 0.1
    router[:, 0] += x.mean(0) * 4        # most tokens prefer expert 0
    _, idx, kept, _ = lm.route(spec, lm.Numerics(), {"l.moe.router": router},
                               "l", x)
    assert lm.capacity(spec, 64) == 24
    assert int((idx == 0).sum()) > 24 and int((~kept).sum()) > 0


def test_fp8_control_rounds_products_and_their_gradients():
    a = torch.linspace(-1, 1, 97)
    q = lm._fp8(a, torch.float8_e4m3fn, 448.0)
    assert not torch.equal(q, a)
    assert float((q - a).abs().max()) <= 2 ** -4 + 1e-7
    assert math.isclose(float(q.abs().max()), 1.0)
    x = torch.randn(5, 7, requires_grad=True)
    w = torch.randn(7, 3, requires_grad=True)
    y = lm.Numerics(fp8=True).ein("td,df->tf", x, w)
    assert not torch.allclose(y, x @ w, rtol=1e-4, atol=1e-4)
    assert torch.allclose(y, x @ w, rtol=0.2, atol=0.2)
    y.sum().backward()
    assert torch.allclose(x.grad, w.sum(1).expand(5, 7), rtol=0.2, atol=0.2)
    assert dataclasses.is_dataclass(lm.Spec)
