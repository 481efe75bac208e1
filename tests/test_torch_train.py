"""The port's training path (``train/``, the flash backward, the
checkpointed cross entropy, ``remat``, ``launch/train.py``) against the
reference's, on the same inputs: numpy draws from fixed seeds, and the
reference's own initialised params and train state loaded into the
port through ``params_from_reference`` / ``train_state_from_reference``.
Float32 smoke configurations; JAX is imported inside the tests.

Tolerances: gradients, losses and grad norms at rtol/atol 1e-4
(``MODEL_TOL``, the port's logit tolerance).  After AdamW steps the
moments are held at ``MOMENT_TOL`` (measured: m within 9.6e-9, v within
1.3e-10 after three steps) and the params at ``PARAM_TOL``: an update
is mhat / (sqrt(vhat) + eps), g / (|g| + eps) at the first step, so
where |g| is near eps a last-bit difference in a gradient moves a
parameter by up to 2 lr.  Measured on these inputs: at most 3.6e-5, on
20 of the ~100,000 parameters, after three steps at lr <= 1e-3; the
rest within 1e-6."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from _threads import few_torch_threads  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core import GlobalVOL, make_store
from repro_torch.core import format as pt_fmt
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models import attention as pt_attn
from repro_torch.models import inputs as pt_inputs
from repro_torch.models import layers as pt_layers
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model
from repro_torch.train import optimizer as pt_opt
from repro_torch.train import steps as pt_steps
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
PARAM_TOL = {"rtol": 1e-5, "atol": 1e-4}
MOMENT_TOL = {"rtol": 1e-5, "atol": 1e-7}
OPT_TOL = {"rtol": 1e-6, "atol": 1e-7}   # one update, float32 rounding
ARCH = "yi_9b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype=np.float32) \
        if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _flat(tree) -> dict:
    import jax
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_states(got, want) -> None:
    """Train states in the reference's layout: params at PARAM_TOL,
    moments at MOMENT_TOL, the step exactly."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        tol = PARAM_TOL if k.startswith("['params']") else MOMENT_TOL
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **tol,
                                   err_msg=k)
    assert int(got["['opt']['step']"]) == int(want["['opt']['step']"])


@pytest.fixture(scope="module", autouse=True)
def cpu_decode():
    from repro.core import format as ref_fmt
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup,total", [(3, 12), (1, 1), (0, 5)])
def test_lr_schedule_equals_reference(warmup, total):
    import jax.numpy as jnp

    from repro.train import optimizer as ref_opt
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total)
    ref = ref_opt.lr_schedule(ref_opt.OptConfig(**kw))
    pt = pt_opt.lr_schedule(pt_opt.OptConfig(**kw))
    for s in range(total + 4):
        got = pt(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, ref(jnp.asarray(s, jnp.int32)), OPT_TOL)


def _opt_tree(rng, dtype_of):
    """A mixed float32 / bf16 tree: 2-D and 1-D leaves of each."""
    shapes = {"w": (8, 16), "b": (16,), "e": (4, 8, 16), "s": (16,)}
    dt = {"w": "float32", "b": "float32", "e": "bfloat16", "s": "bfloat16"}
    return {k: dtype_of(dt[k], rng.normal(size=shp).astype(np.float32))
            for k, shp in shapes.items()}


def _jax_leaf(dtype, a):
    import jax.numpy as jnp
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _torch_leaf(dtype, a):
    return _t(a).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def test_global_norm_equals_reference():
    from repro.train import optimizer as ref_opt
    tree = _opt_tree(np.random.default_rng(0), _torch_leaf)
    ref = _opt_tree(np.random.default_rng(0), _jax_leaf)
    _close(pt_opt.global_norm(tree), ref_opt.global_norm(ref), OPT_TOL)
    assert pt_opt.global_norm(tree).dtype == torch.float32


@pytest.mark.parametrize("step,gscale", [(0, 1.0), (4, 0.01)],
                         ids=["first-clipped", "fifth"])
def test_adamw_update_equals_reference(step, gscale):
    """A mixed float32 / bf16 tree, clipped (grad norm > 1) and not."""
    import jax.numpy as jnp

    from repro.train import optimizer as ref_opt
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)

    def tree(seed, make, scale=1.0, sq=False):
        t = _opt_tree(np.random.default_rng(seed), lambda d, a: make(
            d, (a * a if sq else a) * scale))
        return t

    def moments(make):
        return {"m": tree(2, lambda d, a: make("float32", a), 0.01),
                "v": tree(3, lambda d, a: make("float32", a), 1e-4, True)}

    grads, params = tree(0, _torch_leaf, gscale), tree(1, _torch_leaf)
    opt = dict(moments(_torch_leaf),
               step=torch.tensor(step, dtype=torch.int32))
    rgrads, rparams = tree(0, _jax_leaf, gscale), tree(1, _jax_leaf)
    ropt = dict(moments(_jax_leaf), step=jnp.asarray(step, jnp.int32))
    rp, ro, rn = ref_opt.adamw_update(ref_opt.OptConfig(**cfg), rgrads,
                                      rparams, ropt)
    p, o, n = pt_opt.adamw_update(pt_opt.OptConfig(**cfg), grads, params,
                                  opt)
    assert p is params and o is opt              # updated in place
    _close(n, rn, OPT_TOL)
    assert int(o["step"]) == step + 1 and o["step"].dtype == torch.int32
    for k in params:
        assert p[k].dtype == _torch_leaf(
            "bfloat16" if k in "es" else "float32", np.zeros(1)).dtype
        tol = OPT_TOL if k in "wb" else {"rtol": 1e-2, "atol": 1e-2}
        _close(p[k], rp[k], tol)                 # bf16: one rounding
        _close(o["m"][k], ro["m"][k], OPT_TOL)
        _close(o["v"][k], ro["v"][k], OPT_TOL)


def test_adamw_decays_only_matrices():
    """With zero gradients and moments the update is -lr * wd * p on
    2-D and 3-D leaves and nothing on 1-D ones."""
    params = _opt_tree(np.random.default_rng(0), _torch_leaf)
    before = {k: v.clone() for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = pt_opt.init_opt_state(params)
    cfg = pt_opt.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    pt_opt.adamw_update(cfg, grads, params, opt)
    for k, p in params.items():
        if p.ndim >= 2:
            assert not torch.equal(p, before[k]), k
            np.testing.assert_allclose(
                _np(p), _np(before[k]) * (1 - 1e-2 * 0.5),
                rtol=1e-2 if p.dtype == torch.bfloat16 else 1e-6)
        else:
            assert torch.equal(p, before[k]), k


def test_opt_state_shapes_and_specs():
    params = _opt_tree(np.random.default_rng(0), _torch_leaf)
    st = pt_opt.init_opt_state(params)
    ab = pt_opt.abstract_opt_state(params)
    for part in ("m", "v"):
        for k, p in params.items():
            assert st[part][k].shape == p.shape == ab[part][k].shape
            assert st[part][k].dtype == ab[part][k].dtype == torch.float32
            assert ab[part][k].device.type == "meta"
            assert not st[part][k].any()
    assert st["step"].dtype == ab["step"].dtype == torch.int32
    specs = {k: ("fsdp",) for k in params}
    assert pt_opt.opt_state_specs(specs) == {"m": specs, "v": specs,
                                             "step": ()}


# ------------------------------------------------------------ flash backward
def _qkv(rng, B, Sq, Sk, H, K, hd):
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, K, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, K, hd)).astype(np.float32))


def _pt_flash_grads(q, k, v, dout, impl, **kw):
    q, k, v = (_t(x).requires_grad_() for x in (q, k, v))
    out = pt_attn.flash_attention(q, k, v, impl=impl, **kw)
    return (out, *torch.autograd.grad(out, (q, k, v), _t(dout)))


@pytest.mark.parametrize("S", [64, 16], ids=["blocks", "one-block"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("q_offset", [0, 16])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_backward_equals_reference(G, q_offset, causal, S):
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(10 + G + q_offset)
    K, hd = 2, 16
    Sq = S if q_offset == 0 or S == 16 else S - q_offset
    q, k, v = _qkv(rng, 2, Sq, S, G * K, K, hd)
    dout = rng.normal(size=(2, Sq, G * K, hd)).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, block_q=16, block_k=16)

    def f(q, k, v):
        return ref_attn.flash_attention(q, k, v, impl="vjp", **kw)

    want_out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = _pt_flash_grads(q, k, v, dout, "vjp", **kw)
    _close(got[0], want_out, MODEL_TOL)
    for name, g, w in zip("qkv", got[1:], want):
        _close(g, w, MODEL_TOL)
    # autograd through the checkpointed forward loop gives the same
    scan = _pt_flash_grads(q, k, v, dout, "scan", **kw)
    assert torch.equal(scan[0], got[0])
    for g, w in zip(scan[1:], got[1:]):
        _close(g, w, MODEL_TOL)


def test_flash_impls_and_forward_agree_without_grad():
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(3), 1, 32, 32,
                                   4, 2, 8))
    plain = pt_attn.flash_attention(q, k, v, block_q=16, block_k=16)
    for impl in ("vjp", "scan"):
        got = pt_attn.flash_attention(q, k, v, block_q=16, block_k=16,
                                      impl=impl)
        assert torch.equal(got, plain)
    with pytest.raises(ValueError, match="unknown impl"):
        pt_attn.flash_attention(q, k, v, impl="pallas")


def test_flash_backward_keeps_bf16_dtypes():
    q, k, v = (_t(x).to(torch.bfloat16) for x in
               _qkv(np.random.default_rng(4), 1, 32, 32, 4, 2, 8))
    dout = torch.ones_like(q)
    got = _pt_flash_grads(q.float().numpy(), k.float().numpy(),
                          v.float().numpy(), dout.float().numpy(), "vjp",
                          block_q=16, block_k=16)
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    out = pt_attn.flash_attention(qb, kb, vb, block_q=16, block_k=16)
    grads = torch.autograd.grad(out, (qb, kb, vb), dout)
    for g, x, f in zip(grads, (q, k, v), got[1:]):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        np.testing.assert_allclose(_np(g), _np(f), rtol=0.05, atol=0.05)


# ------------------------------------------------------------ cross entropy
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 1024)])
def test_chunked_softmax_xent_grads_equal_reference(S, chunk):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, S, 32)).astype(np.float32)
    head = (rng.normal(size=(32, 96)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 96, (2, S)).astype(np.int32)
    lab[0, :5] = -1                                   # masked positions
    lab[1, -3:] = -1

    def f(h, head):
        return ref_layers.chunked_softmax_xent(h, head, jnp.asarray(lab),
                                               chunk=chunk)[0]

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th, thead = _t(h).requires_grad_(), _t(head).requires_grad_()
    loss, _ = pt_layers.chunked_softmax_xent(th, thead, _t(lab), chunk=chunk)
    got = torch.autograd.grad(loss, (th, thead))
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)
    assert not got[0][0, :5].any()                # masked rows: no grad


# -------------------------------------------------------------- whole model
def _ref_model(remat="none"):
    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    return ref_build(ref_base.get_config(ARCH, smoke=True), remat=remat)


def _pt_model(remat="none"):
    return build_model(get_config(ARCH, smoke=True), remat=remat,
                       device="cpu")


def _batch(B, S, seed):
    from repro.configs import base as ref_base
    from repro.models import inputs as ref_inputs
    rb = ref_inputs.make_batch(ref_base.get_config(ARCH, smoke=True), B, S,
                               seed=seed)
    pb = pt_inputs.make_batch(get_config(ARCH, smoke=True), B, S, seed=seed,
                              device="cpu")
    return rb, pb


@functools.cache
def _ref_state(seed=1):
    """The reference's model and initial train state (immutable arrays,
    so tests share one)."""
    import jax

    from repro.train import steps as ref_steps
    rmodel = _ref_model()
    return rmodel, ref_steps.init_train_state(rmodel, jax.random.PRNGKey(seed))


def _param_grads(model, batch) -> dict:
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_model_loss_grads_equal_reference():
    import jax

    rmodel, rstate = _ref_state()
    rb, pb = _batch(2, 64, seed=3)
    rgrads = jax.jit(jax.grad(lambda p: rmodel.loss(p, rb)[0]))(
        rstate["params"])
    model = _pt_model()
    pt_tr.params_from_reference(model, jax.device_get(rstate["params"]))
    grads = _param_grads(model, pb)
    want = _flat({"params": rgrads})
    got = _flat({"params": pt_tr._reference_tree(grads)})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **MODEL_TOL,
                                   err_msg=k)


def test_remat_policies_give_equal_grads():
    import jax

    _, rstate = _ref_state()
    _, pb = _batch(2, 64, seed=5)
    grads = {}
    for remat in ("none", "dots", "full"):
        model = _pt_model(remat)
        pt_tr.params_from_reference(model, jax.device_get(rstate["params"]))
        grads[remat] = _param_grads(model, pb)
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)
    with pytest.raises(ValueError, match="remat"):
        _pt_model("some")


def test_abstract_train_state_equals_reference():
    from repro.train import steps as ref_steps
    rshapes, rspecs = ref_steps.abstract_train_state(_ref_model())
    shapes, specs = pt_steps.abstract_train_state(_pt_model())
    got, want = _flat(shapes), _flat(rshapes)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    import jax
    from jax.sharding import PartitionSpec as P
    rs = {jax.tree_util.keystr(k): tuple(v) for k, v in
          jax.tree_util.tree_flatten_with_path(
              rspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    ps = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(
              specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert ps == rs
    assert pt_steps.metric_specs({"loss": 0, "nll": 1}) == {"loss": (),
                                                            "nll": ()}


def test_train_state_round_trips_through_the_reference_tree():
    import jax

    _, rstate = _ref_state()
    tree = jax.device_get(rstate)
    state = pt_tr.train_state_from_reference(_pt_model(), tree)
    assert state["opt"]["step"].dtype == torch.int32
    back = pt_tr.train_state_to_reference(state)
    got, want = _flat(back), _flat(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "cpu"
        assert np.array_equal(_np(got[k]), _np(w)), k


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_reference(microbatches):
    """Metrics after each of three steps; the whole state after the
    first and the third."""
    import jax

    from repro.train import optimizer as ref_opt
    from repro.train import steps as ref_steps
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rmodel, rstate = _ref_state()
    model = _pt_model()
    state = pt_tr.train_state_from_reference(model, jax.device_get(rstate))
    rstep = jax.jit(ref_steps.make_train_step(
        rmodel, ref_opt.OptConfig(**kw), microbatches=microbatches))
    step = pt_steps.make_train_step(model, pt_opt.OptConfig(**kw),
                                    microbatches=microbatches)
    for i in range(3):
        rb, pb = _batch(4, 32, seed=20 + i)
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, pb)
        assert sorted(m) == sorted(rm)
        for k in ("loss", "nll", "accuracy", "tokens", "aux_loss",
                  "grad_norm"):
            assert m[k].shape == () and m[k].dtype == torch.float32, k
            _close(m[k], rm[k], MODEL_TOL)
        assert int(m["step"]) == int(rm["step"]) == i + 1
        if i in (0, 2):
            _close_states(pt_tr.train_state_to_reference(state),
                          jax.device_get(rstate))


def test_microbatches_average_the_full_batch_gradient():
    _, pb = _batch(4, 32, seed=7)
    results = []
    for mb in (1, 2):
        model = _pt_model().init(torch.Generator().manual_seed(0))
        state = {"params": dict(model.named_parameters())}
        state["opt"] = pt_opt.init_opt_state(state["params"])
        step = pt_steps.make_train_step(model, pt_opt.OptConfig(),
                                        microbatches=mb)
        results.append(step(state, pb)[1])
    for k in ("loss", "grad_norm"):
        _close(results[1][k], results[0][k], MODEL_TOL)
    # metrics are means over micro-batches, as in the reference
    assert float(results[1]["tokens"]) * 2 == float(results[0]["tokens"])


def test_eval_step_matches_loss():
    model = _pt_model().init(torch.Generator().manual_seed(0))
    _, pb = _batch(2, 32, seed=8)
    out = pt_steps.make_eval_step(model)(pb)
    loss, _ = model.loss(pb)
    assert torch.equal(out["loss"], loss.detach())
    assert not out["loss"].requires_grad


# ------------------------------------------------------------------ trainer
@pytest.fixture(scope="module")
def world():
    store = make_store(5, replicas=2)
    vol = GlobalVOL(store)
    build_corpus(vol, CorpusSpec(n_seqs=128, seq_len=64, vocab_size=256,
                                 seed=1))
    yield store, vol
    store.close()


def mk_trainer(store, vol, total=8, ckpt_every=4, packed=False):
    model = build_model(get_config(ARCH, smoke=True), remat="none",
                        device="cpu")
    loader = ObjectDataLoader(vol, "corpus", global_batch=8, seed=3,
                              prefetch=0, packed=packed)
    return Trainer(model, loader, store,
                   opt=pt_opt.OptConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=50),
                   cfg=TrainerConfig(total_steps=total,
                                     ckpt_every=ckpt_every, log_every=100,
                                     packed_ingest=packed),
                   log=lambda s: None)


def _leaves(state) -> dict:
    return _flat(pt_tr.train_state_to_reference(state))


def test_loss_decreases_and_restart_is_bit_deterministic(world):
    store, vol = world
    for name in store.list_objects("ckpt/"):
        store.delete(name)
    tr = mk_trainer(store, vol)
    state = tr.run()
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]
    assert [r["step"] for r in tr.history] == list(range(1, 9))
    final = _leaves(state)

    tr2 = mk_trainer(store, vol)
    _, start = tr2.init_or_restore()
    assert start == 8
    # wipe checkpoints except step 4, rerun 4..8, compare every leaf
    for name in store.list_objects("ckpt/train/step-8/"):
        store.delete(name)
    tr3 = mk_trainer(store, vol)
    st3, start3 = tr3.init_or_restore()
    assert start3 == 4 and int(st3["opt"]["step"]) == 4
    st3 = tr3.run(st3, start_step=4)
    again = _leaves(st3)
    assert sorted(again) == sorted(final) and len(final) == 3 * 12 + 1
    for k, a in final.items():
        assert a.dtype == again[k].dtype and torch.equal(a, again[k]), k
    assert [r["loss"] for r in tr3.history] == \
        [r["loss"] for r in tr.history[4:]]


def test_checkpoint_holds_the_reference_layout(world):
    """The leaf keys, dtypes and shapes of a train checkpoint are the
    reference's train state's."""
    import json

    import jax
    store, vol = world
    for name in store.list_objects("ckpt/"):
        store.delete(name)
    mk_trainer(store, vol, total=2, ckpt_every=2).run()
    manifest = json.loads(store.get("ckpt/train/step-2/.manifest"))
    _, rstate = _ref_state()
    want = {k: (str(v.dtype), list(v.shape))
            for k, v in _flat(jax.eval_shape(lambda: rstate)).items()}
    got = {k: (m["dtype"], m["shape"])
           for k, m in manifest["leaves"].items()}
    assert got == want
    assert manifest["extra"] == {"loader_step": 2}


def test_packed_ingest_training(world):
    store, vol = world
    for name in store.list_objects("ckpt/"):
        store.delete(name)
    tr = mk_trainer(store, vol, total=4, ckpt_every=100, packed=True)
    tr.run()
    assert np.isfinite(tr.history[-1]["loss"])
    # the same steps from plain batches give the same losses
    plain = mk_trainer(store, vol, total=4, ckpt_every=100)
    plain.run()
    assert [r["loss"] for r in tr.history] == \
        [r["loss"] for r in plain.history]


def test_straggler_monitor_flags_spikes():
    mon = StragglerMonitor(alpha=0.5, factor=2.0)
    assert not mon.observe(0.1)
    assert not mon.observe(0.11)
    assert mon.observe(0.5)
    assert mon.flagged == 1


def test_port_continues_a_reference_checkpoint():
    """The reference's Trainer saves step 4; the port restores it and
    runs to step 8; its losses equal the reference's own continuation
    at MODEL_TOL."""
    from repro.core import GlobalVOL as RefVOL
    from repro.core import make_store as ref_make_store
    from repro.data.corpus import CorpusSpec as RefSpec
    from repro.data.corpus import build_corpus as ref_build_corpus
    from repro.data.pipeline import ObjectDataLoader as RefLoader
    from repro.train.optimizer import OptConfig as RefOpt
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefCfg
    from repro_torch.core.store import ObjectStore

    rstore = ref_make_store(5, replicas=2)
    ref_build_corpus(RefVOL(rstore), RefSpec(n_seqs=128, seq_len=64,
                                             vocab_size=256, seed=1))

    def ref_trainer(total):
        loader = RefLoader(RefVOL(rstore), "corpus", global_batch=8, seed=3,
                           prefetch=0)
        return RefTrainer(_ref_model(), loader, rstore,
                          opt=RefOpt(lr=1e-3, warmup_steps=2,
                                     total_steps=50),
                          cfg=RefCfg(total_steps=total, ckpt_every=4,
                                     log_every=100), log=lambda s: None)

    ref_trainer(4).run()
    pstore = ObjectStore.from_state(_export(rstore))
    want = ref_trainer(8)
    want.run()
    tr = mk_trainer(pstore, GlobalVOL(pstore), total=8)
    state, start = tr.init_or_restore()
    assert start == 4
    tr.run(state, start_step=start)
    got = [r["loss"] for r in tr.history]
    np.testing.assert_allclose(got, [r["loss"] for r in want.history],
                               **MODEL_TOL)
    pstore.close()
    rstore.close()


def _export(ref_store) -> dict:
    c = ref_store.cluster
    return {"cluster": {"osds": list(c.osds), "n_pgs": c.n_pgs,
                        "replicas": c.replicas, "epoch": c.epoch,
                        "weights": dict(c.weights), "down": sorted(c.down)},
            "osds": {o: {"data": dict(osd.data),
                         "xattrs": {n: dict(x) for n, x in
                                    osd.xattrs.items()}}
                     for o, osd in ref_store.osds.items()},
            "vclock": ref_store._vclock}


# ----------------------------------------------------------------- launcher
def test_launch_train_smoke_on_cpu(capsys):
    from repro_torch.launch import train as launch
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "6", "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] done: loss" in out
    first, last = (float(x) for x in
                   out.split("loss ")[-1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run there")
    from repro_torch.launch import train as launch
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        build_model(get_config(ARCH, smoke=True))
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        launch.main(["--arch", ARCH, "--smoke", "--steps", "2"])


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_flash_backward_on_the_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 64, 64, 8, 2, 32)
    dout = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, block_q=16, block_k=16)
    want = _pt_flash_grads(q, k, v, dout, "vjp", **kw)
    dev = torch.device("cuda:0")
    tq, tk, tv = (_t(x).to(dev).requires_grad_() for x in (q, k, v))
    out = pt_attn.flash_attention(tq, tk, tv, **kw)
    got = (out, *torch.autograd.grad(out, (tq, tk, tv), _t(dout).to(dev)))
    for g, w in zip(got, want):
        assert g.device == dev
        _close(g, w, MODEL_TOL)


def test_dataclass_defaults_equal_reference():
    from repro.train import optimizer as ref_opt
    from repro.train import trainer as ref_trainer
    from repro_torch.train import trainer as pt_trainer
    assert dataclasses.asdict(pt_opt.OptConfig()) == \
        dataclasses.asdict(ref_opt.OptConfig())
    assert dataclasses.asdict(pt_trainer.TrainerConfig()) == \
        dataclasses.asdict(ref_trainer.TrainerConfig())
    assert dataclasses.asdict(StragglerMonitor()) == \
        dataclasses.asdict(ref_trainer.StragglerMonitor())
