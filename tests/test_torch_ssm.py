"""The port's SSM layers (``models/ssm.py``: Mamba2 and RWKV6) and
recurrent models (``models/recurrent.py``: ``RWKVModel`` and
``ZambaModel``) against the reference's, on the same inputs: numpy
draws from fixed seeds, and the reference's own initialised params and
train states loaded into the port.  Float32 smoke configurations of
rwkv6_3b and zamba2_2p7b; JAX is imported inside the tests, and the
reference's calls are jitted.

Tolerances: the layers at rtol/atol 1e-5 (``TOL``), whole models at
1e-4 (``MODEL_TOL``); after two train steps params at atol 1e-4, as
``test_torch_train.py`` says why, and moments within a fraction of each
leaf's largest entry (``MOMENT_SCALE_TOL`` says why).  Served tokens,
shapes, specs, decay masks, the params round trip and parked caches
are exact."""

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
from repro_torch.models import inputs as pt_inputs
from repro_torch.models import ssm as pt_ssm
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model
from repro_torch.models.recurrent import RWKVModel, ZambaModel
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as pt_opt
from repro_torch.train import steps as pt_steps
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_checkpoint import make_store_from, ref_store_from

TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
PARAM_TOL = {"rtol": 1e-5, "atol": 1e-4}
RWKV, ZAMBA = "rwkv6_3b", "zamba2_2p7b"
ARCHS = (RWKV, ZAMBA)
CHUNK = 16                    # both smoke configs' ssm.chunk


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


def _cfgs(arch):
    from repro.configs import base as ref_base
    return get_config(arch, smoke=True), ref_base.get_config(arch,
                                                             smoke=True)


@pytest.fixture(autouse=True)
def cpu_decode():
    from repro.core import format as ref_fmt
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


# ------------------------------------------------------------------ layers
def _draw(rng, pd) -> dict[str, np.ndarray]:
    """Random float32 values for every leaf of a port ParameterDict:
    weights normal * d_in^-0.5, token-shift mixes in [0, 1), the rest
    O(1) around the reference's constants, so that every term counts."""
    out = {}
    for k, p in pd.items():
        shape = tuple(p.shape)
        if k.startswith("mu_"):
            a = rng.uniform(size=shape)
        elif k in ("dt_bias", "A_log", "u"):
            a = 0.5 * rng.normal(size=shape)
        elif k in ("D_skip", "norm_scale", "ln_scale"):
            a = 1.0 + 0.2 * rng.normal(size=shape)
        elif k == "w0":
            a = -1.0 + 0.5 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) * pt_tr.fan_in("", k, shape) ** -0.5
        out[k] = a.astype(np.float32)
    return out


def _both(p: dict):
    import jax.numpy as jnp
    return ({k: _t(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _x(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state"])
@pytest.mark.parametrize("S", [CHUNK, 2 * CHUNK, 3 * CHUNK])
def test_mamba2_forward_equals_reference(S, with_state):
    """Chunked SSD at one, two and three chunks, from a zero state or a
    given one, with and without the state it leaves (ssd and the
    pre-conv tail)."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm
    cfg, rcfg = _cfgs(ZAMBA)
    rng = np.random.default_rng(S + with_state)
    pp, rp = _both(_draw(rng, pt_ssm.init_mamba2(cfg)))
    _, H, Pd, N = pt_ssm.mamba_dims(cfg)
    x = _x(rng, 2, S, cfg.d_model)
    h0 = _x(rng, 2, H, Pd, N) if with_state else None
    out, st = pt_ssm.mamba2_forward(
        cfg, pp, _t(x), None if h0 is None else _t(h0),
        state_out=with_state)
    rout, rst = jax.jit(functools.partial(
        ref_ssm.mamba2_forward, rcfg, state_out=with_state))(
        rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    _close(out, rout)
    assert out.shape == (2, S, cfg.d_model)
    if with_state:
        assert sorted(st) == ["conv", "ssd"]
        _close(st["ssd"], rst["ssd"])
        _close(st["conv"], rst["conv"])
        assert st["conv"].shape == (2, cfg.ssm.d_conv - 1, H, Pd)
    else:
        assert st is None and rst is None


def test_mamba2_decode_equals_reference():
    """One step from a non-zero SSD state and conv window: the output,
    the new state and the shifted window."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm
    cfg, rcfg = _cfgs(ZAMBA)
    rng = np.random.default_rng(7)
    pp, rp = _both(_draw(rng, pt_ssm.init_mamba2(cfg)))
    _, H, Pd, N = pt_ssm.mamba_dims(cfg)
    x = _x(rng, 3, 1, cfg.d_model)
    state = {"ssd": _x(rng, 3, H, Pd, N),
             "conv": _x(rng, 3, cfg.ssm.d_conv - 1, H, Pd)}
    out, st = pt_ssm.mamba2_decode(cfg, pp, _t(x),
                                   {k: _t(v) for k, v in state.items()})
    rout, rst = jax.jit(functools.partial(ref_ssm.mamba2_decode, rcfg))(
        rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    _close(out, rout)
    _close(st["ssd"], rst["ssd"])
    _close(st["conv"], rst["conv"])
    np.testing.assert_array_equal(_np(st["conv"])[:, :-1],
                                  state["conv"][:, 1:])
    zero = pt_ssm.init_mamba2_state(cfg, 3)
    assert zero["ssd"].shape == (3, H, Pd, N) and not zero["ssd"].any()
    assert zero["conv"].shape == (3, cfg.ssm.d_conv - 1, H, Pd)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state"])
@pytest.mark.parametrize("S", [CHUNK, 3 * CHUNK])
def test_rwkv6_tmix_equals_reference(S, with_state):
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm
    cfg, rcfg = _cfgs(RWKV)
    rng = np.random.default_rng(10 + S + with_state)
    tmix, _ = pt_ssm.init_rwkv6(cfg)
    pp, rp = _both(_draw(rng, tmix))
    H, Pd = cfg.n_heads, cfg.head_dim
    x = _x(rng, 2, S, cfg.d_model)
    s0 = _x(rng, 2, H, Pd, Pd) if with_state else None
    out, st = pt_ssm.rwkv6_tmix(cfg, pp, _t(x),
                                None if s0 is None else _t(s0),
                                state_out=with_state)
    rout, rst = jax.jit(functools.partial(
        ref_ssm.rwkv6_tmix, rcfg, state_out=with_state))(
        rp, jnp.asarray(x), None if s0 is None else jnp.asarray(s0))
    _close(out, rout)
    if with_state:
        _close(st, rst)
        assert st.shape == (2, H, Pd, Pd) and st.dtype == torch.float32
    else:
        assert st is None and rst is None


def test_rwkv6_tmix_decode_equals_reference():
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm
    cfg, rcfg = _cfgs(RWKV)
    rng = np.random.default_rng(11)
    tmix, _ = pt_ssm.init_rwkv6(cfg)
    pp, rp = _both(_draw(rng, tmix))
    H, Pd = cfg.n_heads, cfg.head_dim
    x, xp = _x(rng, 3, 1, cfg.d_model), _x(rng, 3, 1, cfg.d_model)
    s0 = _x(rng, 3, H, Pd, Pd)
    out, st = pt_ssm.rwkv6_tmix_decode(cfg, pp, _t(x), _t(xp), _t(s0))
    rout, rst = jax.jit(functools.partial(ref_ssm.rwkv6_tmix_decode, rcfg))(
        rp, jnp.asarray(x), jnp.asarray(xp), jnp.asarray(s0))
    _close(out, rout)
    _close(st, rst)


@pytest.mark.parametrize("given", [False, True], ids=["shifted", "x_prev"])
def test_rwkv6_cmix_equals_reference(given):
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm
    cfg, rcfg = _cfgs(RWKV)
    rng = np.random.default_rng(12 + given)
    _, cmix = pt_ssm.init_rwkv6(cfg)
    pp, rp = _both(_draw(rng, cmix))
    S = 1 if given else 24
    x = _x(rng, 2, S, cfg.d_model)
    xp = _x(rng, 2, S, cfg.d_model) if given else None
    out = pt_ssm.rwkv6_cmix(cfg, pp, _t(x), None if xp is None else _t(xp))
    rout = ref_ssm.rwkv6_cmix(rcfg, rp, jnp.asarray(x),
                              None if xp is None else jnp.asarray(xp))
    _close(out, rout)


def test_rwkv6_keeps_the_decay_path_in_float32():
    """In a bf16 model the mixes, decay LoRA, bonus and group norm stay
    float32, and a forward keeps the activations' dtype."""
    import dataclasses
    cfg = dataclasses.replace(get_config(RWKV, smoke=True),
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    tmix, cmix = pt_ssm.init_rwkv6(cfg)
    f32 = {k for k, p in {**tmix, **cmix}.items()
           if p.dtype == torch.float32}
    assert f32 == {"mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "wlA",
                   "wlB", "u", "ln_scale", "mu_ck", "mu_cr"}
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for pd in (tmix, cmix):
            for k, v in _draw(rng, pd).items():
                pd[k].copy_(_t(v))
        x = _t(_x(rng, 2, 32, cfg.d_model)).to(torch.bfloat16)
        out, st = pt_ssm.rwkv6_tmix(cfg, tmix, x, state_out=True)
        assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
        assert bool(torch.isfinite(out.float()).all())
        assert pt_ssm.rwkv6_cmix(cfg, cmix, x).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_not_a_multiple_of_the_chunk_raises(arch):
    """Past one chunk, a length must be a multiple of the chunk: the
    reference asserts, the port raises ValueError; within one chunk any
    length runs."""
    rmodel, params = _ref(arch)
    model = _pair(arch)[2]
    toks = np.ones((2, CHUNK + 1), np.int32)
    with pytest.raises(AssertionError):
        rmodel.prefill(params, {"tokens": toks})
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of"):
        model.prefill({"tokens": _t(toks)})
    with torch.no_grad():
        logits, _ = model.prefill({"tokens": _t(toks[:, :CHUNK - 3])})
    assert logits.shape == (2, model.cfg.vocab_size)


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


# the params tree's counts at full size (bf16: 2 bytes a parameter, but
# rwkv6_3b's float32 decay LoRA, mixes and norms)
FULL_PARAMS = {RWKV: (3_073_484_800, 6_170_255_360),
               ZAMBA: (2_396_144_800, 4_793_160_320)}


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_archs_build(arch):
    cls = RWKVModel if arch == RWKV else ZambaModel
    smoke = build_model(get_config(arch, smoke=True), device="cpu")
    full = build_model(get_config(arch), device="meta")
    assert type(smoke) is cls and type(full) is cls
    assert smoke.device.type == "cpu" and full.device.type == "meta"
    n = sum(p.numel() for p in full.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in full.parameters())
    assert (n, nbytes) == FULL_PARAMS[arch]
    if arch == ZAMBA:
        assert (full.n_groups, full.n_inner) == (9, 6)
        assert len(full.mamba) == 9 and all(len(g) == 6 for g in full.mamba)
    else:
        assert len(full.blocks) == 32
    with pytest.raises(ValueError, match="remat"):
        build_model(get_config(arch, smoke=True), remat="some",
                    device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_reference_tree(arch):
    import jax
    _, params, model = _pair(arch)
    want = _flat(jax.device_get(params))
    got = _flat(pt_tr.params_to_reference(model))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k], np.asarray(w)), k
    key = ("['mamba']['mamba']['wz']" if arch == ZAMBA
           else "['blocks']['tmix']['wlA']")
    assert key in got


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    import jax
    rmodel, params, model = _pair(arch)
    rb, pb = _batches(arch, 2, 3 * CHUNK, seed=3)
    (rloss, rm), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(params, rb)
    loss, m = model.loss(pb)
    _close(loss, rloss, MODEL_TOL)
    for k in ("nll", "accuracy", "tokens", "aux_loss"):
        _close(m[k], rm[k], MODEL_TOL, k)
    assert float(m["aux_loss"]) == 0.0
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    got, want = _flat(pt_tr._reference_tree(grads)), _flat(rgrads)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], MODEL_TOL, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_grads(arch):
    _, pb = _batches(arch, 2, 2 * CHUNK, seed=5)
    grads = {}
    for remat in ("none", "dots", "full"):
        model = _pair(arch, remat)[2]
        loss, _ = model.loss(pb)
        names, ps = zip(*model.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, ps)))
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


def _pad_cache(cache, n, ref: bool):
    import jax.numpy as jnp
    out = dict(cache)
    for k in ("k", "v"):
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


CACHE_KEYS = {RWKV: ["cprev", "pos", "tprev", "wkv"],
              ZAMBA: ["conv", "k", "pos", "ssd", "v"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch):
    """Prefill of 2 chunks, then 5 tokens one at a time: logits and every
    cache leaf against the reference's."""
    import jax
    rmodel, params, model = _pair(arch)
    cfg = model.cfg
    S = 2 * CHUNK
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, S + 5)).astype(np.int32)
    rlogits, rcache = jax.jit(rmodel.prefill)(params, {"tokens": toks[:, :S]})
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": _t(toks[:, :S])})
    _close(logits, rlogits, MODEL_TOL)
    assert sorted(cache) == sorted(rcache) == CACHE_KEYS[arch]
    for k in cache:
        assert tuple(cache[k].shape) == tuple(rcache[k].shape), k
        assert str(cache[k].dtype).removeprefix("torch.") == \
            np.dtype(rcache[k].dtype).name, k
        _close(cache[k], rcache[k], MODEL_TOL, k)
    assert int(cache["pos"]) == S
    rcache, cache = _pad_cache(rcache, 5, True), _pad_cache(cache, 5, False)
    decode = jax.jit(rmodel.decode_step)
    for t in range(S, S + 5):
        rlogits, rcache = decode(params, toks[:, t:t + 1], rcache)
        with torch.no_grad():
            logits, cache = model.decode_step(_t(toks[:, t:t + 1]), cache)
        _close(logits, rlogits, MODEL_TOL, f"step {t}")
    for k in cache:
        _close(cache[k], rcache[k], MODEL_TOL, k)
    assert int(cache["pos"]) == S + 5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_prefill(arch):
    """``tests/test_models.py``'s invariant on the port alone: prefill
    half, decode the rest token by token, against one prefill."""
    model = _pair(arch)[2]
    S = 2 * CHUNK
    _, pb = _batches(arch, 2, S, seed=0)
    toks = pb["tokens"]
    with torch.no_grad():
        full, _ = model.prefill({"tokens": toks})
        logits, cache = model.prefill({"tokens": toks[:, :S // 2]})
        cache = _pad_cache(cache, S - S // 2, False)
        for t in range(S // 2, S):
            logits, cache = model.decode_step(toks[:, t:t + 1], cache)
    _close(logits, full, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
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
    full = build_model(get_config(arch), device="meta").abstract_cache(
        8, 4096)[0]
    want = ({"wkv": (32, 8, 40, 64, 64), "tprev": (32, 8, 2560),
             "cprev": (32, 8, 2560), "pos": ()} if arch == RWKV else
            {"ssd": (9, 6, 8, 80, 64, 64), "conv": (9, 6, 8, 3, 80, 64),
             "k": (9, 8, 4096, 32, 80), "v": (9, 8, 4096, 32, 80),
             "pos": ()})
    assert {k: tuple(v.shape) for k, v in full.items()} == want
    nbytes = sum(v.numel() * v.element_size() for v in full.values())
    assert nbytes == (170_393_604 if arch == RWKV else 3_599_400_964)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_equal_reference(arch):
    """Prompts left-padded to 2 chunks, 8 new tokens each."""
    ref, pt = _engines(arch, 48)
    rreqs, preqs = _requests([5, 2 * CHUNK, 9], 8, seed=1)
    want, got = ref.generate(rreqs), pt.generate(preqs)
    assert [c.steps for c in got] == [c.steps for c in want] == [8] * 3
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
    last, rlast = pt._last_cache, ref._last_cache
    assert sorted(last) == sorted(rlast) == CACHE_KEYS[arch]
    for k in last:
        if k in ("k", "v"):
            assert last[k].shape[2] == 48
        _close(last[k], rlast[k], MODEL_TOL, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_sessions_move_between_packages_bit_equal(arch):
    """Each package parks its cache (the recurrent leaves whole, zamba's
    k / v in pages); the other resumes it bit-equal."""
    import repro.core as ref_core
    rs, ps = ref_core.make_store(4, replicas=2), make_store(4, replicas=2)
    ref, pt = _engines(arch, 40, rs, ps)
    rreqs, preqs = _requests([6, CHUNK, 3], 5, seed=3)
    ref.generate(rreqs)
    pt.generate(preqs)
    ref.park_session("from-ref")
    pt.park_session("from-pt")
    assert sorted(ps.list_objects("kv/from-pt/")) == sorted(
        n.replace("from-ref", "from-pt")
        for n in rs.list_objects("kv/from-ref/"))
    _, pt2 = _engines(arch, 40, None, make_store_from(rs))
    got = pt2.resume_session("from-ref", batch=3)
    ref2, _ = _engines(arch, 40, ref_store_from(ps), None)
    back = ref2.resume_session("from-pt", batch=3)
    assert sorted(got) == CACHE_KEYS[arch]
    for key in CACHE_KEYS[arch]:
        assert pytree.to_bytes(got[key]) == np.ascontiguousarray(
            np.asarray(ref._last_cache[key])).tobytes(), key
        assert np.ascontiguousarray(np.asarray(back[key])).tobytes() == \
            pytree.to_bytes(pt._last_cache[key]), key
    for s in (rs, ps):
        s.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_cpu(arch, capsys):
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "3", "--max-new", "4"])
    train_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "4", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[serve] 3 reqs, 12 tokens, " in out
    assert "[serve] parked KV pages: " in out
    first, last = (float(x) for x in
                   out.split("loss ")[-1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


# ------------------------------------------------------------ train state
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_decay_equals_ndim_rule_on_the_reference_tree(arch):
    """The reference decays where ``p.ndim >= 2`` in its tree: every
    stacked leaf (rwkv's blocks on L, zamba's mamba on (G, K)), the
    (H,) SSM leaves and (D,) mixes included; of the unstacked leaves
    only the matrices (not ``ln_in``, the final norm or zamba's shared
    norms)."""
    import jax
    _, params, model = _pair(arch)
    decay = pt_steps.reference_decay(dict(model.named_parameters()))
    want = {k: np.ndim(v) >= 2 for k, v in
            _flat(jax.device_get(params)).items()}
    got = _flat(pt_tr._reference_tree(
        {n: torch.tensor(d) for n, d in decay.items()}))
    assert all(v.all() or not v.any() for v in got.values())
    assert {k: bool(v.all()) for k, v in got.items()} == want
    assert not decay["final_norm.scale"]
    if arch == ZAMBA:
        assert decay["mamba.0.0.mamba.dt_bias"] and decay["mamba.1.1.ln.scale"]
        assert not decay["shared.ln1.scale"] and decay["shared.attn.wq"]
    else:
        assert decay["blocks.0.tmix.mu_r"] and decay["blocks.1.ln1.bias"]
        assert not decay["ln_in.scale"] and not decay["ln_in.bias"]


# After two AdamW steps each moment leaf is held within this fraction of
# its largest entry (beside an atol of 1e-7), and zamba's grad norm at
# this rtol.  The smoke models' float32 gradients are ill-conditioned
# in a few entries: in zamba's layer (0, 1) one head's gated-norm input
# has a mean square of ~4e-7 against the norm's eps of 1e-5, so its
# backward amplifies rounding, and the reference's own jitted and eager
# gradients already differ there (``scripts/ssm_conditioning.py``
# prints both packages' spreads).  Params are held at PARAM_TOL but for
# at most this fraction of all their entries, each of which must stay
# within the two steps' largest update (an entry whose gradient is ~0
# takes a step of either sign: Adam divides it by its own scale).
MOMENT_SCALE_TOL = {RWKV: 1e-4, ZAMBA: 2e-2}
GRAD_NORM_RTOL = {RWKV: MODEL_TOL["rtol"], ZAMBA: 1e-2}
PARAM_OUTLIERS = {RWKV: 0.0, ZAMBA: 1e-3}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch):
    import jax

    from repro.train import optimizer as ref_opt
    from repro.train import steps as ref_steps
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rmodel, _ = _ref(arch)
    rstate = jax.jit(functools.partial(ref_steps.init_train_state, rmodel))(
        jax.random.PRNGKey(1))
    model = build_model(get_config(arch, smoke=True), remat="none",
                        device="cpu")
    state = pt_tr.train_state_from_reference(model, jax.device_get(rstate))
    rstep = jax.jit(ref_steps.make_train_step(rmodel,
                                              ref_opt.OptConfig(**kw)))
    step = pt_steps.make_train_step(model, pt_opt.OptConfig(**kw))
    for i in range(2):
        rb, pb = _batches(arch, 4, 2 * CHUNK, seed=20 + i)
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, pb)
        for k in ("loss", "nll", "accuracy", "tokens", "aux_loss"):
            _close(m[k], rm[k], MODEL_TOL, k)
        _close(m["grad_norm"], rm["grad_norm"],
               dict(MODEL_TOL, rtol=GRAD_NORM_RTOL[arch]), "grad_norm")
    got = _flat(pt_tr.train_state_to_reference(state))
    want = _flat(jax.device_get(rstate))
    assert sorted(got) == sorted(want)
    # each step moves an entry by at most its learning rate (|m| <= sqrt(v)
    # after bias correction) plus its decay
    sched = pt_opt.lr_schedule(pt_opt.OptConfig(**kw))
    moved = sum(float(sched(torch.tensor(t))) for t in (1, 2)) * 1.01
    outliers = entries = 0
    for k in want:
        if k.startswith("['params']"):
            g, w = _np(got[k]), np.asarray(want[k])
            off = ~np.isclose(g, w, **PARAM_TOL)
            outliers, entries = outliers + int(off.sum()), entries + off.size
            assert np.abs(g - w).max(initial=0.0) <= 2 * moved, k
        elif k != "['opt']['step']":
            w = np.asarray(want[k])
            scale = MOMENT_SCALE_TOL[arch] * float(np.abs(w).max())
            _close(got[k], w, {"rtol": 0.0, "atol": 1e-7 + scale}, k)
    assert outliers <= PARAM_OUTLIERS[arch] * entries, (outliers, entries)
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


def _ref_trainer(arch, store, total):
    from repro.core import GlobalVOL as RefVOL
    from repro.data.pipeline import ObjectDataLoader as RefLoader
    from repro.train.optimizer import OptConfig as RefOpt
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefCfg
    loader = RefLoader(RefVOL(store), "corpus", global_batch=4, seed=3,
                       prefetch=0)
    return RefTrainer(_ref(arch)[0], loader, store,
                      opt=RefOpt(lr=1e-3, warmup_steps=2, total_steps=50),
                      cfg=RefCfg(total_steps=total, ckpt_every=2,
                                 log_every=100), log=lambda s: None)


def _pt_trainer(arch, store, total):
    model = build_model(get_config(arch, smoke=True), remat="none",
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
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_continue_across_packages(arch, saver):
    """One package's Trainer saves step 2; the other restores it and
    runs to step 4, its losses equal to the saver's own run to step 4 at
    MODEL_TOL.  The checkpoint's leaf keys, dtypes and shapes are the
    reference's train state's (zamba's mamba stacked on (G, K))."""
    import json

    import jax
    from repro.train import steps as ref_steps
    ref_saves = saver == "reference"
    store = _world(ref_saves)
    make, other = ((_ref_trainer, _pt_trainer) if ref_saves
                   else (_pt_trainer, _ref_trainer))
    saver = make(arch, store, 2)
    if ref_saves:       # the reference's init, jitted (eager it compiles
        state = jax.jit(functools.partial(   # each operation of it)
            ref_steps.init_train_state, _ref(arch)[0]))(
            jax.random.PRNGKey(0))
        state = saver.run(state, start_step=0)
    else:
        state = saver.run()
    manifest = json.loads(store.get("ckpt/train/step-2/.manifest"))
    want_keys = _flat(jax.eval_shape(lambda: ref_steps.init_train_state(
        _ref(arch)[0], jax.random.PRNGKey(0))))
    assert {k: (m["dtype"], m["shape"]) for k, m in
            manifest["leaves"].items()} == {
        k: (str(v.dtype), list(v.shape)) for k, v in want_keys.items()}
    moved = (make_store_from if ref_saves else ref_store_from)(store)
    # the saver's own run goes on to step 4 uninterrupted (the same
    # Trainer, so the reference compiles its step once)
    saver.cfg = dataclasses.replace(saver.cfg, total_steps=4)
    saver.run(state, start_step=2)
    tr = other(arch, moved, 4)
    state, start = tr.init_or_restore()
    assert start == 2
    tr.run(state, start_step=start)
    np.testing.assert_allclose([r["loss"] for r in tr.history],
                               [r["loss"] for r in saver.history[2:]],
                               **MODEL_TOL)
    for s in (store, moved):
        s.close()


# ----------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_smoke_model_on_the_card_equals_cpu(arch):
    """The smoke model with the same weights on the card and on the CPU:
    loss and gradients, prefill and decode logits, the caches, and the
    served tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch, smoke=True)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    pb = pt_inputs.make_batch(cfg, 2, 3 * CHUNK, seed=6, device="cpu")
    want, _ = cpu.loss(pb)
    got, _ = card.loss({k: v.cuda() for k, v in pb.items()})
    _close(got, want, MODEL_TOL)
    wg = torch.autograd.grad(want, list(cpu.parameters()))
    gg = torch.autograd.grad(got, list(card.parameters()))
    for (name, _), g, w in zip(cpu.named_parameters(), gg, wg):
        # zamba's gradients move with the op order (MOMENT_SCALE_TOL)
        scale = MOMENT_SCALE_TOL[arch] * float(w.abs().max())
        _close(g, w, dict(MODEL_TOL, atol=MODEL_TOL["atol"] + scale), name)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 2 * CHUNK + 4)).astype(np.int32))
    with torch.inference_mode():
        want, wc = cpu.prefill({"tokens": toks[:, :2 * CHUNK]})
        got, gc = card.prefill({"tokens": toks[:, :2 * CHUNK].cuda()})
        _close(got, want, MODEL_TOL)
        wc = ServeEngine(cpu, max_seq=48)._pad_cache(wc)
        gc = ServeEngine(card, max_seq=48)._pad_cache(gc)
        for t in range(4):
            nxt = toks[:, 2 * CHUNK + t:2 * CHUNK + t + 1]
            want, wc = cpu.decode_step(nxt, wc)
            got, gc = card.decode_step(nxt.cuda(), gc)
            _close(got, want, MODEL_TOL)
        for k in wc:
            _close(gc[k], wc[k], MODEL_TOL, k)
    rng = np.random.default_rng(7)
    preqs = [Request(rng.integers(1, cfg.vocab_size, n).astype(np.int32), 12)
             for n in (7, 2 * CHUNK, 16)]
    want = ServeEngine(cpu, max_seq=64).generate(preqs)
    got = ServeEngine(card, max_seq=64).generate(preqs)
    for g, w in zip(got, want):
        assert np.array_equal(g.tokens, w.tokens)
