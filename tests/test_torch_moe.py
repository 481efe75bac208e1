"""The port's mixture of experts (``models/moe.py``), MLA (the MLA half
of ``models/attention.py``) and the moe family's ``TransformerLM``
against the reference's, on the same inputs: numpy draws from fixed
seeds, and the reference's own initialised params and train states
loaded into the port.  Float32 smoke configurations of
deepseek_v2_lite_16b (MLA, a dense pre-block, shared experts) and
grok1_314b (GQA, no shared experts); JAX is imported inside the tests.

Tolerances: the expert FFN, MLA and the flash forward at rtol/atol 1e-5
(``TOL``), the flash backward and whole models at 1e-4 (``MODEL_TOL``);
after a train step params at atol 1e-4 and moments at 1e-7, as
``test_torch_train.py`` says why."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from _threads import few_torch_threads  # noqa: F401

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core import GlobalVOL, make_store
from repro_torch.core import format as pt_fmt
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as pt_attn
from repro_torch.models import inputs as pt_inputs
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as pt_opt
from repro_torch.train import steps as pt_steps
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_checkpoint import make_store_from, ref_store_from

TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
PARAM_TOL = {"rtol": 1e-5, "atol": 1e-4}
MOMENT_TOL = {"rtol": 1e-5, "atol": 1e-7}
MOE_ARCHS = ("deepseek_v2_lite_16b", "grok1_314b")
DS = "deepseek_v2_lite_16b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL, msg="") -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=msg)


def _flat(tree) -> dict:
    import jax
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(arch, **moe):
    """(port config, reference config) of ``arch``'s smoke model, with
    ``moe`` fields replaced in both."""
    from repro.configs import base as ref_base
    cfg, rcfg = get_config(arch, smoke=True), ref_base.get_config(
        arch, smoke=True)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
    return cfg, rcfg


@pytest.fixture(autouse=True)
def cpu_decode():
    from repro.core import format as ref_fmt
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


# ---------------------------------------------------------------------- moe
def _moe_params(rng, cfg):
    m, d = cfg.moe, cfg.d_model
    E, Fe = m.n_routed, m.d_ff_expert
    p = {"router": rng.normal(size=(d, E)) * d ** -.5,
         "w1": rng.normal(size=(E, d, Fe)) * d ** -.5,
         "w3": rng.normal(size=(E, d, Fe)) * d ** -.5,
         "w2": rng.normal(size=(E, Fe, d)) * Fe ** -.5}
    if m.n_shared:
        Fs = m.n_shared * Fe
        p.update({"sw1": rng.normal(size=(d, Fs)) * d ** -.5,
                  "sw3": rng.normal(size=(d, Fs)) * d ** -.5,
                  "sw2": rng.normal(size=(Fs, d)) * Fs ** -.5})
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    import jax.numpy as jnp
    return ({k: _t(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _dropped(cfg, x, router) -> int:
    """How many (token, expert) entries exceed their expert's capacity."""
    idx = pt_moe._top_k(torch.softmax(_t(x) @ _t(router), -1),
                        cfg.moe.top_k)[1]
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_routed)
    return int(torch.clamp_min(counts - pt_moe._capacity(len(x), cfg),
                               0).sum())


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_math_equals_reference(arch, cf):
    """Out, aux and zloss; at 0.5 and 1.25 the experts drop tokens."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as ref_moe
    cfg, rcfg = _cfgs(arch, capacity_factor=cf)
    rng = np.random.default_rng(0)
    pp, rp = _both(_moe_params(rng, cfg))
    # a direction shared by every token skews the routing
    x = (rng.normal(size=(2, 48, cfg.d_model))
         + 1.5 * rng.normal(size=cfg.d_model)).astype(np.float32)
    T = 96
    for n in (1, 2, 3, 8, 95, 96, 97, 1000):
        assert pt_moe._capacity(n, cfg) == ref_moe._capacity(n, rcfg)
    dropped = _dropped(cfg, x.reshape(T, -1), pp["router"])
    assert (dropped > 0) == (cf < 8.0), dropped
    shared = tuple(pp[k] for k in ("sw1", "sw3", "sw2") if k in pp)
    rshared = tuple(rp[k] for k in ("sw1", "sw3", "sw2") if k in rp)
    out, aux, z = pt_moe._moe_math(cfg, _t(x.reshape(T, -1)), pp["router"],
                                   pp["w1"], pp["w3"], pp["w2"],
                                   shared or None)
    rout, raux, rz = jax.jit(functools.partial(
        ref_moe._moe_math, rcfg, reduce_axes=None))(
        jnp.asarray(x.reshape(T, -1)), rp["router"], rp["w1"], rp["w3"],
        rp["w2"], rshared or None)
    _close(out, rout)
    _close(aux, raux)
    _close(z, rz)
    assert aux.dtype == z.dtype == torch.float32 and aux.shape == ()
    got, gaux = pt_moe.moe_ffn(cfg, pp, _t(x))
    want, waux = jax.jit(functools.partial(ref_moe.moe_ffn, rcfg))(
        rp, jnp.asarray(x))
    _close(got, want)
    _close(gaux, waux)


def test_top_k_takes_equal_probabilities_lowest_expert_first():
    import jax
    import jax.numpy as jnp
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.1, 0.3, 0.3, 0.0, 0.3],
                      [0.2] * 5], np.float32)
    vals, idx = pt_moe._top_k(_t(probs), 3)
    rvals, ridx = jax.lax.top_k(jnp.asarray(probs), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(vals.numpy(), np.asarray(rvals))
    assert idx.tolist() == [[0, 1, 3], [1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_moe_under_active_rules_equals_reference(strategy):
    """The reference's shard_map bodies on a one-device (data, model)
    mesh against the port's moe_ffn under the same strategy's rules: the
    same numbers as without rules."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.distributed import sharding as ref_shd
    from repro.models import moe as ref_moe
    cfg, rcfg = _cfgs(DS, capacity_factor=1.25)
    rng = np.random.default_rng(1)
    pp, rp = _both(_moe_params(rng, cfg))
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    plain, plain_aux = pt_moe.moe_ffn(cfg, pp, _t(x))
    names = ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), names)

    class _Mesh:
        mesh_dim_names = names

    with ref_shd.use_rules(ref_shd.MeshRules(mesh, strategy=strategy)):
        want, waux = jax.jit(functools.partial(ref_moe.moe_ffn, rcfg))(
            rp, jnp.asarray(x))
    with shd.use_rules(shd.MeshRules(_Mesh(), strategy=strategy)):
        got, gaux = pt_moe.moe_ffn(cfg, pp, _t(x))
    _close(got, want)
    _close(gaux, waux)
    assert torch.equal(got, plain) and torch.equal(gaux, plain_aux)


def test_moe_combine_is_deterministic_and_keeps_gate_dtype():
    cfg, _ = _cfgs(DS, capacity_factor=1.25)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    p = {k: _t(v).to(torch.float32 if k == "router" else torch.bfloat16)
         for k, v in _moe_params(rng, cfg).items()}
    x = _t(rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)).to(
        torch.bfloat16)
    a, aux = pt_moe.moe_ffn(cfg, p, x)
    b, _ = pt_moe.moe_ffn(cfg, p, x)
    assert a.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.equal(a, b)


# ---------------------------------------------------------------------- mla
def _mla_params(rng, cfg):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    r, nope, rope, v = (m.kv_lora_rank, m.qk_nope_head_dim,
                        m.qk_rope_head_dim, m.v_head_dim)
    p = {"wq": rng.normal(size=(d, H, nope + rope)) * d ** -.5,
         "wdkv": rng.normal(size=(d, r + rope)) * d ** -.5,
         "wuk": rng.normal(size=(r, H, nope)) * r ** -.5,
         "wuv": rng.normal(size=(r, H, v)) * r ** -.5,
         "wo": rng.normal(size=(H, v, d)) * (H * v) ** -.5}
    return {k: a.astype(np.float32) for k, a in p.items()}


def test_mla_forward_equals_reference():
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    cfg, rcfg = _cfgs(DS)
    rng = np.random.default_rng(3)
    pp, rp = _both(_mla_params(rng, cfg))
    assert {k: tuple(v.shape) for k, v in pp.items()} == {
        k: tuple(v.shape) for k, v in pt_attn.init_mla(cfg).items()}
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    out, (ckv, krope) = pt_attn.mla_forward(cfg, pp, _t(x), _t(pos),
                                            kv_out=True)
    rout, (rckv, rkrope) = ref_attn.mla_forward(
        rcfg, rp, jnp.asarray(x), jnp.asarray(pos), kv_out=True)
    _close(out, rout)
    _close(ckv, rckv)
    _close(krope, rkrope)
    assert ckv.shape == (2, 32, cfg.mla.kv_lora_rank)
    assert krope.shape == (2, 32, cfg.mla.qk_rope_head_dim)


@pytest.mark.parametrize("pos", [0, 9, 15, 19], ids=lambda p: f"pos{p}")
def test_mla_decode_equals_reference(pos):
    """pos 19 lies past the 16 slots: both write slot 15."""
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    cfg, rcfg = _cfgs(DS)
    rng = np.random.default_rng(4)
    pp, rp = _both(_mla_params(rng, cfg))
    m, S = cfg.mla, 16
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(3, S, m.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(3, S, m.qk_rope_head_dim)).astype(np.float32)
    out, c2, k2 = pt_attn.mla_decode(cfg, pp, _t(x), torch.tensor(
        pos, dtype=torch.int32), _t(ckv), _t(krope))
    rout, rc2, rk2 = ref_attn.mla_decode(rcfg, rp, jnp.asarray(x),
                                         jnp.asarray(pos, jnp.int32),
                                         jnp.asarray(ckv),
                                         jnp.asarray(krope))
    _close(out, rout)
    _close(c2, rc2)
    _close(k2, rk2)
    changed = np.flatnonzero((c2.numpy() != ckv).any(axis=(0, 2)))
    assert changed.tolist() == [min(pos, S - 1)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_with_wider_qk_than_v_equals_reference(G, causal):
    """hd 24 for q and k, 16 for v (MLA's 192 / 128): forward at 1e-5,
    the vjp backward at 1e-4, and the scan route's gradients equal."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(5 + G)
    B, S, K, hd, hdv = 2, 48, 2, 24, 16
    H = G * K
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hdv)).astype(np.float32)
    dout = rng.normal(size=(B, S, H, hdv)).astype(np.float32)
    kw = dict(causal=causal, block_q=16, block_k=16)

    def f(q, k, v):
        return ref_attn.flash_attention(q, k, v, impl="vjp", **kw)

    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(dout))
    for impl in ("vjp", "scan"):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        out = pt_attn.flash_attention(tq, tk, tv, impl=impl, **kw)
        assert out.shape == (B, S, H, hdv)
        _close(out, want)
        grads = torch.autograd.grad(out, (tq, tk, tv), _t(dout))
        for g, w, a in zip(grads, wgrads, (q, k, v)):
            assert g.shape == a.shape
            _close(g, w, MODEL_TOL)


# ------------------------------------------------------------ whole models
@functools.cache
def _ref(arch, seed=1):
    """The reference's smoke model and params (immutable: shared)."""
    import jax

    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    rmodel = ref_build(ref_base.get_config(arch, smoke=True), remat="none")
    return rmodel, jax.jit(rmodel.init)(jax.random.PRNGKey(seed))


def _pair(arch, remat="none"):
    import jax
    rmodel, params = _ref(arch)
    model = build_model(get_config(arch, smoke=True), remat=remat,
                        device="cpu")
    pt_tr.params_from_reference(model, jax.device_get(params))
    return rmodel, params, model


def _batches(arch, B, S, seed):
    from repro.configs import base as ref_base
    from repro.models import inputs as ref_inputs
    rb = ref_inputs.make_batch(ref_base.get_config(arch, smoke=True), B, S,
                               seed=seed)
    pb = pt_inputs.make_batch(get_config(arch, smoke=True), B, S, seed=seed,
                              device="cpu")
    return rb, pb


def test_moe_archs_build():
    for arch in MOE_ARCHS:
        model = build_model(get_config(arch), device="meta")
        assert len(model.layers()) == get_config(arch).n_layers
    ds = build_model(get_config(DS), device="meta")
    assert len(ds.pre_blocks) == 1 and hasattr(ds.pre_blocks[0], "mlp")
    assert all(hasattr(b, "moe") for b in ds.blocks)
    n = sum(p.numel() for p in ds.parameters())
    assert n == 15_706_470_400
    assert sum(p.numel() * p.element_size()
               for p in ds.parameters()) == 31_419_981_824


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip_through_the_reference_tree(arch):
    import jax
    _, params, model = _pair(arch)
    want = _flat(jax.device_get(params))
    got = _flat(pt_tr.params_to_reference(model))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k], np.asarray(w)), k
    if arch == DS:
        assert "['pre_blocks'][0]['attn']['wq']" in got


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_shapes_and_specs_equal_reference(arch, smoke):
    """``abstract()`` against the reference's: every leaf's shape and
    dtype, and every spec, the full-size models on the meta device."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    rshapes, rspecs = ref_build(ref_base.get_config(
        arch, smoke=smoke)).abstract()
    shapes, specs = build_model(get_config(arch, smoke=smoke),
                                device="meta").abstract()
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _flat(rshapes).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(shapes).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in _flat(shapes).values())
    rs = {jax.tree_util.keystr(k): tuple(v) for k, v in
          jax.tree_util.tree_flatten_with_path(
              rspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    ps = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(
              specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert ps == rs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_equal_reference(arch):
    import jax
    rmodel, params, model = _pair(arch)
    rb, pb = _batches(arch, 2, 64, seed=3)
    (rloss, rm), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(params, rb)
    loss, m = model.loss(pb)
    _close(loss, rloss, MODEL_TOL)
    for k in ("nll", "accuracy", "tokens", "aux_loss"):
        _close(m[k], rm[k], MODEL_TOL, k)
    assert float(m["aux_loss"].detach()) > 0
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    got, want = _flat(pt_tr._reference_tree(grads)), _flat(rgrads)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], MODEL_TOL, k)


def test_remat_policies_give_equal_moe_grads():
    _, pb = _batches(DS, 2, 32, seed=5)
    grads = {}
    for remat in ("none", "dots", "full"):
        model = _pair(DS, remat)[2]
        loss, _ = model.loss(pb)
        names, ps = zip(*model.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, ps)))
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


def _pad_cache(cache, n, ref: bool):
    import jax.numpy as jnp
    out = dict(cache)
    for k in ("k", "v", "ckv", "krope"):
        if k not in cache:
            continue
        if ref:
            widths = [(0, 0)] * cache[k].ndim
            widths[2] = (0, n)
            out[k] = jnp.pad(cache[k], widths)
        else:
            a = cache[k]
            out[k] = torch.cat([a, a.new_zeros((*a.shape[:2], n,
                                                *a.shape[3:]))], dim=2)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_equal_reference(arch):
    import jax
    rmodel, params, model = _pair(arch)
    cfg = model.cfg
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 36)).astype(np.int32)
    rlogits, rcache = jax.jit(rmodel.prefill)(params, {"tokens": toks[:, :32]})
    logits, cache = model.prefill({"tokens": _t(toks[:, :32])})
    _close(logits, rlogits, MODEL_TOL)
    keys = ["ckv", "krope", "pos"] if cfg.attention == "mla" else \
        ["k", "pos", "v"]
    assert sorted(cache) == sorted(rcache) == keys
    for k in keys[:-1] if cfg.attention == "mla" else ("k", "v"):
        assert cache[k].shape[0] == cfg.n_layers
        _close(cache[k], rcache[k], MODEL_TOL, k)
    assert int(cache["pos"]) == int(rcache["pos"]) == 32
    rcache, cache = _pad_cache(rcache, 4, True), _pad_cache(cache, 4, False)
    decode = jax.jit(rmodel.decode_step)
    for t in range(32, 36):
        rlogits, rcache = decode(params, toks[:, t:t + 1], rcache)
        logits, cache = model.decode_step(_t(toks[:, t:t + 1]), cache)
        _close(logits, rlogits, MODEL_TOL, f"step {t}")
    for k in cache:
        _close(cache[k], rcache[k], MODEL_TOL, k)
    assert int(cache["pos"]) == 36


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cache_specs_equal_reference(arch):
    rmodel, _ = _ref(arch)
    model = build_model(get_config(arch, smoke=True), device="meta")
    for B in (1, 4):
        rshapes, rspecs = rmodel.abstract_cache(B, 96)
        shapes, specs = model.abstract_cache(B, 96)
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in rshapes.items()} == \
            {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
             for k, v in shapes.items()}
        assert {k: tuple(v) for k, v in rspecs.items()} == specs
    full = build_model(get_config(DS), device="meta").abstract_cache(8, 4096)
    assert {k: tuple(v.shape) for k, v in full[0].items()} == {
        "ckv": (27, 8, 4096, 512), "krope": (27, 8, 4096, 64), "pos": ()}
    assert sum(v.numel() * v.element_size()
               for k, v in full[0].items() if k != "pos") == 1_019_215_872


def _engines(arch, max_seq, ref_store=None, pt_store=None):
    import jax

    from repro.serve.engine import ServeEngine as RefEngine
    rmodel, params = _ref(arch, seed=2)
    model = build_model(get_config(arch, smoke=True), device="cpu")
    pt_tr.params_from_reference(model, jax.device_get(params))
    return (RefEngine(rmodel, params, max_seq=max_seq, store=ref_store),
            ServeEngine(model, max_seq=max_seq, store=pt_store))


def _requests(lengths, max_new, seed=0):
    from repro.serve.engine import Request as RefRequest
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in lengths]
    return ([RefRequest(p.copy(), max_new) for p in prompts],
            [Request(p, max_new) for p in prompts])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_served_tokens_equal_reference(arch):
    ref, pt = _engines(arch, 40)
    rreqs, preqs = _requests([5, 17, 9], 8, seed=1)
    want, got = ref.generate(rreqs), pt.generate(preqs)
    assert [c.steps for c in got] == [c.steps for c in want] == [8] * 3
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
    last, rlast = pt._last_cache, ref._last_cache
    assert sorted(last) == sorted(rlast)
    for k in last:
        if k != "pos":
            assert last[k].shape[2] == 40
        _close(last[k], rlast[k], MODEL_TOL, k)


def test_latent_kv_sessions_move_between_packages_bit_equal():
    import repro.core as ref_core
    rs, ps = ref_core.make_store(4, replicas=2), make_store(4, replicas=2)
    ref, pt = _engines(DS, 40, rs, ps)
    rreqs, preqs = _requests([6, 11, 3], 5, seed=3)
    ref.generate(rreqs)
    pt.generate(preqs)
    ref.park_session("from-ref")
    pt.park_session("from-pt")
    assert sorted(ps.list_objects("kv/from-pt/")) == sorted(
        n.replace("from-ref", "from-pt")
        for n in rs.list_objects("kv/from-ref/"))
    _, pt2 = _engines(DS, 40, None, make_store_from(rs))
    got = pt2.resume_session("from-ref", batch=3)
    ref2, _ = _engines(DS, 40, ref_store_from(ps), None)
    back = ref2.resume_session("from-pt", batch=3)
    assert sorted(got) == ["ckv", "krope", "pos"]
    for key in ("ckv", "krope", "pos"):
        assert pytree.to_bytes(got[key]) == np.ascontiguousarray(
            np.asarray(ref._last_cache[key])).tobytes(), key
        assert np.ascontiguousarray(np.asarray(back[key])).tobytes() == \
            pytree.to_bytes(pt._last_cache[key]), key
    for s in (rs, ps):
        s.close()


def test_launchers_run_deepseek_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    serve_launch.main(["--arch", DS, "--smoke", "--device", "cpu",
                       "--batch", "3", "--max-new", "4"])
    train_launch.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                       "--device", "cpu", "--steps", "4", "--ckpt-every",
                       "2"])
    out = capsys.readouterr().out
    assert "[serve] 3 reqs, 12 tokens, " in out
    assert "[serve] parked KV pages: " in out
    first, last = (float(x) for x in
                   out.split("loss ")[-1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


# ------------------------------------------------------------ train state
def test_reference_decay_on_pre_blocks():
    """The reference decays where ``p.ndim >= 2`` in its tree: every
    stacked block leaf, and of the unstacked pre-block leaves only the
    matrices; norm scales there and the final norm are not decayed."""
    import jax
    _, params, model = _pair(DS)
    decay = pt_steps.reference_decay(dict(model.named_parameters()))
    want = {k: np.ndim(v) >= 2 for k, v in
            _flat(jax.device_get(params)).items()}
    got = _flat(pt_tr._reference_tree(
        {n: torch.tensor(d) for n, d in decay.items()}))
    assert all(v.all() or not v.any() for v in got.values())
    assert {k: bool(v.all()) for k, v in got.items()} == want
    assert not decay["pre_blocks.0.ln1.scale"]
    assert decay["pre_blocks.0.mlp.w1"] and decay["blocks.0.ln1.scale"]


def test_train_step_equals_reference():
    import jax

    from repro.train import optimizer as ref_opt
    from repro.train import steps as ref_steps
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rmodel, _ = _ref(DS)
    rstate = jax.jit(functools.partial(ref_steps.init_train_state, rmodel))(
        jax.random.PRNGKey(1))
    model = build_model(get_config(DS, smoke=True), remat="none",
                        device="cpu")
    state = pt_tr.train_state_from_reference(model, jax.device_get(rstate))
    rstep = jax.jit(ref_steps.make_train_step(rmodel,
                                              ref_opt.OptConfig(**kw)))
    step = pt_steps.make_train_step(model, pt_opt.OptConfig(**kw))
    for i in range(2):
        rb, pb = _batches(DS, 4, 32, seed=20 + i)
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, pb)
        for k in ("loss", "nll", "accuracy", "tokens", "aux_loss",
                  "grad_norm"):
            _close(m[k], rm[k], MODEL_TOL, k)
    got = _flat(pt_tr.train_state_to_reference(state))
    want = _flat(jax.device_get(rstate))
    assert sorted(got) == sorted(want)
    for k in want:
        tol = PARAM_TOL if k.startswith("['params']") else MOMENT_TOL
        _close(got[k], want[k], tol, k)
    assert int(got["['opt']['step']"]) == 2


def _world(ref: bool):
    if ref:
        from repro.core import GlobalVOL as RefVOL
        from repro.core import make_store as ref_make_store
        from repro.data.corpus import CorpusSpec as RefSpec
        from repro.data.corpus import build_corpus as ref_build_corpus
        store = ref_make_store(5, replicas=2)
        ref_build_corpus(RefVOL(store), RefSpec(n_seqs=64, seq_len=32,
                                                vocab_size=256, seed=1))
        return store
    store = make_store(5, replicas=2)
    build_corpus(GlobalVOL(store), CorpusSpec(n_seqs=64, seq_len=32,
                                              vocab_size=256, seed=1))
    return store


def _ref_trainer(store, total):
    from repro.core import GlobalVOL as RefVOL
    from repro.data.pipeline import ObjectDataLoader as RefLoader
    from repro.train.optimizer import OptConfig as RefOpt
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefCfg
    loader = RefLoader(RefVOL(store), "corpus", global_batch=4, seed=3,
                       prefetch=0)
    return RefTrainer(_ref(DS)[0], loader, store,
                      opt=RefOpt(lr=1e-3, warmup_steps=2, total_steps=50),
                      cfg=RefCfg(total_steps=total, ckpt_every=2,
                                 log_every=100), log=lambda s: None)


def _pt_trainer(store, total):
    model = build_model(get_config(DS, smoke=True), remat="none",
                        device="cpu")
    loader = ObjectDataLoader(GlobalVOL(store), "corpus", global_batch=4,
                              seed=3, prefetch=0)
    return Trainer(model, loader, store,
                   opt=pt_opt.OptConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=50),
                   cfg=TrainerConfig(total_steps=total, ckpt_every=2,
                                     log_every=100),
                   log=lambda s: None)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_checkpoints_continue_across_packages(saver):
    """One package's Trainer saves step 2; the other restores it and
    runs to step 4, its losses equal to the saver's own continuation at
    MODEL_TOL.  The checkpoint's leaf keys are ``jax.tree_util.keystr``
    of the reference's train state, ``['pre_blocks'][0]`` included."""
    import json

    import jax
    from repro.train import steps as ref_steps
    ref_saves = saver == "reference"
    store = _world(ref_saves)
    make, other = ((_ref_trainer, _pt_trainer) if ref_saves
                   else (_pt_trainer, _ref_trainer))
    make(store, 2).run()
    manifest = json.loads(store.get("ckpt/train/step-2/.manifest"))
    want_keys = _flat(jax.eval_shape(lambda: ref_steps.init_train_state(
        _ref(DS)[0], jax.random.PRNGKey(0))))
    assert sorted(manifest["leaves"]) == sorted(want_keys)
    assert "['params']['pre_blocks'][0]['attn']['wdkv']" in \
        manifest["leaves"]
    assert {k: (m["dtype"], m["shape"]) for k, m in
            manifest["leaves"].items()} == {
        k: (str(v.dtype), list(v.shape)) for k, v in want_keys.items()}
    moved = (make_store_from if ref_saves else ref_store_from)(store)
    want = make(store, 4)
    want.run()
    tr = other(moved, 4)
    state, start = tr.init_or_restore()
    assert start == 2
    tr.run(state, start_step=start)
    np.testing.assert_allclose([r["loss"] for r in tr.history],
                               [r["loss"] for r in want.history],
                               **MODEL_TOL)
    for s in (store, moved):
        s.close()


# ----------------------------------------------------------- on the card
@pytest.mark.gpu
def test_moe_smoke_model_on_the_card_equals_cpu():
    """deepseek_v2_lite_16b's smoke model with the same weights on the
    card and on the CPU: loss and aux, prefill and decode logits, the
    latent cache, and the served tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(DS, smoke=True)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    pb = pt_inputs.make_batch(cfg, 2, 64, seed=6, device="cpu")
    want, wm = cpu.loss(pb)
    got, gm = card.loss({k: v.cuda() for k, v in pb.items()})
    _close(got, want, MODEL_TOL)
    _close(gm["aux_loss"], wm["aux_loss"], MODEL_TOL)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    with torch.inference_mode():
        want, wc = cpu.prefill({"tokens": toks[:, :40]})
        got, gc = card.prefill({"tokens": toks[:, :40].cuda()})
        _close(got, want, MODEL_TOL)
        wc = ServeEngine(cpu, max_seq=48)._pad_cache(wc)
        gc = ServeEngine(card, max_seq=48)._pad_cache(gc)
        for t in range(4):
            nxt = toks[:, 40 + t:41 + t]
            want, wc = cpu.decode_step(nxt, wc)
            got, gc = card.decode_step(nxt.cuda(), gc)
            _close(got, want, MODEL_TOL)
        for k in ("ckv", "krope"):
            _close(gc[k], wc[k], MODEL_TOL, k)
    rng = np.random.default_rng(7)
    preqs = [Request(rng.integers(1, cfg.vocab_size, n).astype(np.int32), 12)
             for n in (7, 30, 16)]
    want = ServeEngine(cpu, max_seq=64).generate(preqs)
    got = ServeEngine(card, max_seq=64).generate(preqs)
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
