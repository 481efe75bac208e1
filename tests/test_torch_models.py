"""The port's configs, sharding rules, layers, attention and dense
transformer against the reference's, on the same inputs: numpy draws
from fixed seeds, and the reference's own initialised params loaded
into the port's modules through ``params_from_reference``.  Float32
smoke configurations; JAX is imported inside the tests."""

import dataclasses

import numpy as np
import pytest
import torch
from _threads import few_torch_threads  # noqa: F401

from repro_torch import configs as pt_configs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as pt_attn
from repro_torch.models import inputs as pt_inputs
from repro_torch.models import layers as pt_layers
from repro_torch.models import transformer as pt_tr
from repro_torch.models.archs import build_model

TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
# the dense-FFN GQA families (dense, audio, vlm); the moe family is held
# in test_torch_moe.py
GQA_ARCHS = ("yi_9b", "starcoder2_7b", "granite_20b", "deepseek_67b",
             "musicgen_large", "pixtral_12b")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ configs
def _plain(v):
    """A config value with dtypes by name and nested configs as dicts."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, type):                       # jnp.bfloat16 and kin
        return np.dtype(v).name
    return v


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference(arch, smoke):
    from repro.configs import base as ref_base
    ref = ref_base.get_config(arch, smoke=smoke)
    pt = get_config(arch.replace("_", "-"), smoke=smoke)
    assert _plain(pt) == _plain(ref)
    assert pt.param_dtype in (torch.bfloat16, torch.float32)
    assert pt.param_count() == ref.param_count()
    assert pt.active_param_count() == ref.active_param_count()
    assert pt.supported_shapes == ref.supported_shapes
    assert pt.quadratic_attention == ref.quadratic_attention


def test_registry_and_shapes_equal_reference():
    from repro.configs import base as ref_base
    assert pt_configs.ARCH_IDS == ref_base.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    reg = pt_configs.registry()
    assert list(reg) == list(ref_base.ARCH_IDS)
    assert all(reg[a] is get_config(a) for a in reg)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama_1t")


# ----------------------------------------------------------------- sharding
MESHES = {"2d": ("data", "model"), "3d": ("pod", "data", "model")}
LOGICAL = (None, "dp", "fsdp", "fsdp_expert", "tp", "act_seq", "sp",
           "tokens", "all", "dp_nopod", "fsdp_nopod", "tp_nopod",
           "tokens_nopod", "all_nopod", "sp_nopod", "data", "model")


class _Mesh:
    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("manual", [(), ("model",)], ids=["auto", "manual"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_sharding_rules_equal_reference(strategy, mesh, manual):
    import jax
    from jax.sharding import Mesh

    from repro.distributed import sharding as ref_shd
    names = MESHES[mesh]
    devs = np.array(jax.devices()[:1]).reshape((1,) * len(names))
    ref = ref_shd.MeshRules(Mesh(devs, names), strategy=strategy,
                            manual_axes=manual)
    pt = shd.MeshRules(_Mesh(names), strategy=strategy, manual_axes=manual)
    assert pt.table == ref.table
    logical = LOGICAL + (("pod", "pod_nopod") if "pod" in names else ())
    for ax in logical:
        assert pt.resolve(ax) == ref.resolve(ax), ax
    assert pt.spec(*logical) == tuple(ref.spec(*logical))
    assert pt.token_axes == ref.token_axes
    assert pt.moe_tp == ref.moe_tp
    assert (pt.dp_axes, pt.all_axes) == (ref.dp_axes, ref.all_axes)
    for bad in (pt, ref):
        with pytest.raises(ValueError, match="unknown logical axis"):
            bad.resolve("heads")


def test_hint_returns_its_input_and_checks_names_under_rules():
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.hint(x, "dp", "nonsense") is x
    with shd.use_rules(shd.MeshRules(_Mesh(("data", "model")))):
        assert shd.hint(x, "dp", "tp") is x
        with pytest.raises(ValueError, match="unknown logical axis"):
            shd.hint(x, "dp", "nonsense")


# ------------------------------------------------------------------- layers
def _cfg(norm="rmsnorm", act="silu_gated"):
    return dataclasses.replace(get_config("yi_9b", smoke=True), norm=norm,
                               act=act)


def _ref_cfg(norm="rmsnorm", act="silu_gated"):
    from repro.configs import base as ref_base
    return dataclasses.replace(ref_base.get_config("yi_9b", smoke=True),
                               norm=norm, act=act)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_equal_reference(norm):
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 128)) * 3 + 0.5).astype(np.float32)
    p = {"scale": rng.normal(size=128).astype(np.float32),
         "bias": rng.normal(size=128).astype(np.float32)}
    want = ref_layers.apply_norm(
        _ref_cfg(norm), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x))
    got = pt_layers.apply_norm(_cfg(norm), {k: _t(v) for k, v in p.items()},
                               _t(x))
    _close(got, want)
    _close(pt_layers.rmsnorm(_t(x), _t(p["scale"])),
           ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(p["scale"])))
    # the norm computes in float32 and casts back to the input's dtype
    xb = _t(x).to(torch.bfloat16)
    assert pt_layers.apply_norm(_cfg(norm), {k: _t(v) for k, v in p.items()},
                                xb).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope_equals_reference(theta):
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    _close(pt_layers.rope_frequencies(32, theta),
           ref_layers.rope_frequencies(32, theta))
    _close(pt_layers.apply_rope(_t(x), _t(pos), theta),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu_gated", "gelu", "relu_sq"])
def test_activation_and_mlp_equal_reference(act):
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(2, 5, 64)) * 2).astype(np.float32)
    g = (rng.normal(size=(2, 5, 64)) * 2).astype(np.float32)
    gate = g if act == "silu_gated" else None
    _close(pt_layers.apply_act(_cfg(act=act), _t(h),
                               None if gate is None else _t(gate)),
           ref_layers.apply_act(_ref_cfg(act=act), jnp.asarray(h),
                                None if gate is None else jnp.asarray(g)))
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"w1": rng.normal(size=(32, 64)).astype(np.float32) * 0.2,
         "w2": rng.normal(size=(64, 32)).astype(np.float32) * 0.2}
    if act == "silu_gated":
        p["w3"] = rng.normal(size=(32, 64)).astype(np.float32) * 0.2
    pt_p = pt_layers.init_mlp(_cfg(act=act), 32, 64, torch.float32)
    assert sorted(pt_p) == sorted(p)
    with torch.no_grad():
        for k, v in p.items():
            pt_p[k].copy_(_t(v))
    _close(pt_layers.apply_mlp(_cfg(act=act), pt_p, _t(x)),
           ref_layers.apply_mlp(_ref_cfg(act=act),
                                {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x)))


def test_embed_equals_reference():
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(3)
    tok = rng.normal(size=(256, 16)).astype(np.float32)
    ids = rng.integers(0, 256, (3, 9)).astype(np.int32)
    got = pt_layers.embed_tokens({"tok": _t(tok)}, _t(ids), torch.float32)
    want = ref_layers.embed_tokens({"tok": jnp.asarray(tok)},
                                   jnp.asarray(ids), jnp.float32)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,chunk", [(64, 1024), (64, 16), (48, 32)])
def test_chunked_softmax_xent_equals_reference(S, chunk):
    import jax.numpy as jnp

    from repro.models import layers as ref_layers
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, S, 32)).astype(np.float32)
    head = (rng.normal(size=(32, 96)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 96, (2, S)).astype(np.int32)
    lab[0, :5] = -1                                   # masked positions
    loss, m = pt_layers.chunked_softmax_xent(_t(h), _t(head), _t(lab),
                                             chunk=chunk)
    rloss, rm = ref_layers.chunked_softmax_xent(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(lab), chunk=chunk)
    _close(loss, rloss)
    for k in ("nll", "accuracy", "tokens"):
        _close(m[k], rm[k])
    assert float(m["tokens"]) == 2 * S - 5


# ---------------------------------------------------------------- attention
def _qkv(rng, B, Sq, Sk, H, K, hd):
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("q_offset", [0, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_attention_equals_reference(G, q_offset, causal):
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(5 + G)
    K, hd, Sk = 2, 16, 64
    Sq = Sk - q_offset
    q, k, v = _qkv(rng, 2, Sq, Sk, G * K, K, hd)
    kw = dict(causal=causal, q_offset=q_offset, block_q=16, block_k=16)
    got = pt_attn.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = ref_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    _close(got, want)
    # one block each way gives the same numbers as many blocks
    one = pt_attn.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  q_offset=q_offset)
    _close(one, want)


def test_flash_attention_keeps_the_block_assert():
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    q, k, v = _qkv(np.random.default_rng(6), 1, 600, 600, 2, 1, 8)
    with pytest.raises(AssertionError):
        ref_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    with pytest.raises(ValueError, match="multiples of the blocks"):
        pt_attn.flash_attention(_t(q), _t(k), _t(v))
    # 1024 = 2 x 512 and 512 itself pass
    for S in (512, 1024):
        q, k, v = _qkv(np.random.default_rng(7), 1, S, S, 2, 1, 8)
        assert pt_attn.flash_attention(_t(q), _t(k), _t(v)).shape == q.shape


def _attn_params(rng, cfg):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": rng.normal(size=(d, H, hd)).astype(np.float32) * d ** -.5,
            "wk": rng.normal(size=(d, K, hd)).astype(np.float32) * d ** -.5,
            "wv": rng.normal(size=(d, K, hd)).astype(np.float32) * d ** -.5,
            "wo": rng.normal(size=(H, hd, d)).astype(np.float32)
            * (H * hd) ** -.5}


def _both_params(p):
    import jax.numpy as jnp
    return ({k: _t(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("arch", ["yi_9b", "granite_20b", "musicgen_large"])
def test_gqa_forward_equals_reference(arch):
    import jax.numpy as jnp

    from repro.configs import base as ref_base
    from repro.models import attention as ref_attn
    cfg, rcfg = get_config(arch, smoke=True), ref_base.get_config(
        arch, smoke=True)
    rng = np.random.default_rng(8)
    pp, rp = _both_params(_attn_params(rng, cfg))
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    out, (k, v) = pt_attn.gqa_forward(cfg, pp, _t(x), _t(pos), kv_out=True)
    rout, (rk, rv) = ref_attn.gqa_forward(rcfg, rp, jnp.asarray(x),
                                          jnp.asarray(pos), kv_out=True)
    _close(out, rout)
    _close(k, rk)
    _close(v, rv)


@pytest.mark.parametrize("pos", [0, 9, 15, 19], ids=lambda p: f"pos{p}")
@pytest.mark.parametrize("arch", ["yi_9b", "granite_20b"])
def test_gqa_decode_equals_reference(arch, pos):
    """pos 19 lies past the 16 slots: both write slot 15 (the reference's
    dynamic_update_slice clamps) and attend every slot."""
    import jax.numpy as jnp

    from repro.configs import base as ref_base
    from repro.models import attention as ref_attn
    cfg, rcfg = get_config(arch, smoke=True), ref_base.get_config(
        arch, smoke=True)
    rng = np.random.default_rng(9)
    pp, rp = _both_params(_attn_params(rng, cfg))
    K, hd, S = cfg.n_kv_heads, cfg.head_dim, 16
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(3, S, K, hd)).astype(np.float32)
    vc = rng.normal(size=(3, S, K, hd)).astype(np.float32)
    out, k2, v2 = pt_attn.gqa_decode(cfg, pp, _t(x), torch.tensor(
        pos, dtype=torch.int32), _t(kc), _t(vc))
    rout, rk2, rv2 = ref_attn.gqa_decode(rcfg, rp, jnp.asarray(x),
                                         jnp.asarray(pos, jnp.int32),
                                         jnp.asarray(kc), jnp.asarray(vc))
    _close(out, rout)
    _close(k2, rk2)
    _close(v2, rv2)
    slot = min(pos, S - 1)
    changed = np.flatnonzero((k2.numpy() != kc).any(axis=(0, 2, 3)))
    assert changed.tolist() == [slot]


def test_quantize_kv_equals_reference_exactly():
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    rng = np.random.default_rng(10)
    x = (rng.normal(size=(2, 3, 33, 4, 16)) * 5).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                               # scale clamps to 1e-8
    x[1, 2, 5, 3, :] = np.linspace(-127, 127, 16) * 0.5   # ties at .5
    q, s = pt_attn.quantize_kv(_t(x))
    rq, rs = ref_attn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("pos", [7, 19], ids=lambda p: f"pos{p}")
def test_gqa_decode_q8_equals_reference(pos):
    import jax.numpy as jnp

    from repro.configs import base as ref_base
    from repro.models import attention as ref_attn
    cfg, rcfg = get_config("yi_9b", smoke=True), ref_base.get_config(
        "yi_9b", smoke=True)
    rng = np.random.default_rng(11)
    pp, rp = _both_params(_attn_params(rng, cfg))
    K, hd, S = cfg.n_kv_heads, cfg.head_dim, 16
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    kq, ks = ref_attn.quantize_kv(jnp.asarray(
        rng.normal(size=(2, S, K, hd)).astype(np.float32)))
    vq, vs = ref_attn.quantize_kv(jnp.asarray(
        rng.normal(size=(2, S, K, hd)).astype(np.float32)))
    caches = [np.asarray(a) for a in (kq, vq, ks, vs)]
    got = pt_attn.gqa_decode_q8(cfg, pp, _t(x), pos, *map(_t, caches))
    want = ref_attn.gqa_decode_q8(rcfg, rp, jnp.asarray(x),
                                  jnp.asarray(pos, jnp.int32),
                                  *map(jnp.asarray, caches))
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8
                           else torch.float32)
        _close(g.float(), np.asarray(w, np.float32))


# -------------------------------------------------------------- transformer
def _pair(arch, seed=1):
    """(reference config, model, params) and the port's model holding
    the same params."""
    import jax

    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    rcfg = ref_base.get_config(arch, smoke=True)
    rmodel = ref_build(rcfg, remat="none")
    params = rmodel.init(jax.random.PRNGKey(seed))
    model = build_model(get_config(arch, smoke=True), device="cpu")
    pt_tr.params_from_reference(model, jax.device_get(params))
    return rcfg, rmodel, params, model


def _batches(arch, B, S, seed):
    from repro.configs import base as ref_base
    from repro.models import inputs as ref_inputs
    rb = ref_inputs.make_batch(ref_base.get_config(arch, smoke=True), B, S,
                               seed=seed)
    pb = pt_inputs.make_batch(get_config(arch, smoke=True), B, S, seed=seed,
                              device="cpu")
    assert sorted(rb) == sorted(pb)
    for k in rb:
        assert np.array_equal(pb[k].numpy(), np.asarray(rb[k])), k
    return rb, pb


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_params_round_trip_through_the_reference_tree(arch):
    import jax
    _, _, params, model = _pair(arch)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        pt_tr.params_to_reference(model))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(got[path], np.asarray(leaf)), path


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_loss_equals_reference(arch):
    import jax
    _, rmodel, params, model = _pair(arch)
    rb, pb = _batches(arch, 2, 64, seed=3)
    rloss, rm = jax.jit(rmodel.loss)(params, rb)
    loss, m = model.loss(pb)
    _close(loss, rloss, MODEL_TOL)
    for k in ("nll", "accuracy", "tokens", "aux_loss"):
        _close(m[k], rm[k], MODEL_TOL)


def _pad_ref_cache(cache, n):
    import jax.numpy as jnp
    out = dict(cache)
    for k in ("k", "v"):
        widths = [(0, 0)] * cache[k].ndim
        widths[2] = (0, n)
        out[k] = jnp.pad(cache[k], widths)
    return out


def _pad_pt_cache(cache, n):
    out = dict(cache)
    for k in ("k", "v"):
        a = cache[k]
        out[k] = torch.cat([a, a.new_zeros((*a.shape[:2], n,
                                            *a.shape[3:]))], dim=2)
    return out


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_prefill_and_decode_equal_reference(arch):
    import jax
    rcfg, rmodel, params, model = _pair(arch)
    rb, pb = _batches(arch, 2, 32, seed=4)
    rb = {k: v for k, v in rb.items() if k != "labels"}
    pb = {k: v for k, v in pb.items() if k != "labels"}
    rlogits, rcache = jax.jit(rmodel.prefill)(params, rb)
    logits, cache = model.prefill(pb)
    _close(logits, rlogits, MODEL_TOL)
    assert sorted(cache) == sorted(rcache) == ["k", "pos", "v"]
    for k in ("k", "v"):
        _close(cache[k], rcache[k], MODEL_TOL)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].ndim == 0
    assert int(cache["pos"]) == int(rcache["pos"]) == 32
    steps = 4
    rcache, cache = _pad_ref_cache(rcache, steps), _pad_pt_cache(cache, steps)
    toks = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    decode = jax.jit(rmodel.decode_step)
    for t in range(steps):
        rlogits, rcache = decode(params, toks[t], rcache)
        logits, cache = model.decode_step(_t(toks[t]), cache)
        _close(logits, rlogits, MODEL_TOL)
    for k in ("k", "v"):
        _close(cache[k], rcache[k], MODEL_TOL)
    assert int(cache["pos"]) == int(rcache["pos"]) == 32 + steps


def test_q8_decode_equals_reference_layers(monkeypatch):
    """The port's model with ``KV_CACHE_QUANT`` against the reference's
    q8 decode built from its own pieces (its module switch stays off).
    A float a last-bit apart can round to the next int8, so the prefill
    caches are held within one step, and decode starts from the
    reference's int8 cache in both packages."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ref_attn
    from repro.models import layers as ref_layers
    from repro.models import transformer as ref_tr
    rcfg, rmodel, params, model = _pair("yi_9b")
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (2, 32))
    _, rcache = jax.jit(rmodel.prefill)(params, {"tokens": jnp.asarray(
        toks, jnp.int32)})
    _, plain = model.prefill({"tokens": _t(toks.astype(np.int32))})
    monkeypatch.setattr(pt_tr, "KV_CACHE_QUANT", True)
    _, cache = model.prefill({"tokens": _t(toks.astype(np.int32))})
    assert {k: v.dtype for k, v in cache.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32, "pos": torch.int32}
    for key in ("k", "v"):
        q, scale = pt_attn.quantize_kv(plain[key])
        assert torch.equal(cache[key], q)
        assert torch.equal(cache[f"{key}_scale"], scale)
        rq, rs = ref_attn.quantize_kv(rcache[key])
        assert np.abs(q.numpy().astype(int)
                      - np.asarray(rq).astype(int)).max() <= 1
        _close(scale, rs)
    steps = 4
    meta, _ = model.abstract_cache(2, 32 + steps)
    assert {k: (v.shape, v.dtype) for k, v in meta.items()} == {
        k: (v.shape[:2] + (32 + steps,) + v.shape[3:] if v.ndim else
            v.shape, v.dtype) for k, v in cache.items()}
    rcache = _pad_ref_cache(rcache, steps)
    kq, ks = ref_attn.quantize_kv(rcache["k"])
    vq, vs = ref_attn.quantize_kv(rcache["v"])
    cache = {"k": _t(kq), "v": _t(vq), "k_scale": _t(ks),
             "v_scale": _t(vs), "pos": cache["pos"]}
    blocks = params["blocks"]
    pos = rcache["pos"]
    new_toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    for t in range(steps):
        h = ref_layers.embed_tokens(params["embed"], new_toks[t], jnp.float32)
        layers = []
        for i in range(rcfg.n_layers):
            p = jax.tree.map(lambda a, i=i: a[i], blocks)
            h, new = ref_tr._decode_step_q8_layer(
                rcfg, p, h, pos, (kq[i], vq[i], ks[i], vs[i]))
            layers.append(new)
        kq, vq, ks, vs = (jnp.stack(c) for c in zip(*layers))
        h = ref_layers.apply_norm(rcfg, params["final_norm"], h)
        rlogits = h[:, -1] @ params["embed"]["head"]
        pos = pos + 1
        logits, cache = model.decode_step(_t(new_toks[t]), cache)
        _close(logits, rlogits, MODEL_TOL)
    assert int(cache["pos"]) == int(pos)
    _close(cache["k_scale"], ks)
    _close(cache["v_scale"], vs)
    for got, want in ((cache["k"], kq), (cache["v"], vq)):
        assert np.abs(got.numpy().astype(int)
                      - np.asarray(want).astype(int)).max() <= 1


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_cache_specs_equal_reference(arch):
    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    rmodel = ref_build(ref_base.get_config(arch, smoke=True))
    model = build_model(get_config(arch, smoke=True), device="meta")
    for B in (1, 4):
        rshapes, rspecs = rmodel.abstract_cache(B, 96)
        shapes, specs = model.abstract_cache(B, 96)
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in rshapes.items()} == \
            {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
             for k, v in shapes.items()}
        assert {k: tuple(v) for k, v in rspecs.items()} == specs
        assert all(v.device.type == "meta" for v in shapes.values())


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_param_shapes_equal_reference(arch, smoke):
    """Every parameter, by the reference's path, at the reference's shape
    and dtype: the full-size models on the meta device."""
    import jax

    from repro.configs import base as ref_base
    from repro.models.archs import build_model as ref_build
    shapes, _ = ref_build(ref_base.get_config(arch, smoke=smoke)).abstract()
    want = {jax.tree_util.keystr(p): (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(get_config(arch, smoke=smoke), device="meta")
    L = len(model.blocks)
    got = {}
    for name, p in model.named_parameters():
        path, index = pt_tr.reference_path(name)
        assert index == ((int(name.split(".")[1]),)
                         if path[0] == "blocks" else ()), name
        got["".join(f"['{k}']" for k in path)] = (
            (L,) * len(index) + tuple(p.shape),
            str(p.dtype).removeprefix("torch."))
    assert got == want


def test_init_is_seeded_and_scaled():
    cfg = get_config("yi_9b", smoke=True)
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    c = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    for (name, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                            b.named_parameters(),
                                            c.named_parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):
            assert torch.all(pa == 1)
            continue
        assert not torch.equal(pa, pc), name
        leaf = name.rsplit(".", 1)[-1]
        d_in = {"tok": cfg.d_model, "wo": cfg.n_heads * cfg.head_dim}.get(
            leaf, pa.shape[0])
        assert abs(float(pa.std()) * d_in ** 0.5 - 1) < 0.1, name


# ------------------------------------------------------------------- inputs
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_input_specs_equal_reference(arch, shape):
    from repro.configs import base as ref_base
    from repro.models import inputs as ref_inputs
    rcfg, cfg = ref_base.get_config(arch), get_config(arch)
    rb, rspecs = ref_inputs.train_input_specs(rcfg, ref_base.SHAPES[shape])
    pb, specs = pt_inputs.train_input_specs(cfg, SHAPES[shape])
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in rb.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
         for k, v in pb.items()}
    assert {k: tuple(v) for k, v in rspecs.items()} == specs
    rt, rspec = ref_inputs.decode_input_specs(rcfg, ref_base.SHAPES[shape])
    pt_, spec = pt_inputs.decode_input_specs(cfg, SHAPES[shape])
    assert tuple(pt_.shape) == tuple(rt.shape) and pt_.dtype == torch.int32
    assert pt_.device.type == "meta" and spec == tuple(rspec)


@pytest.mark.parametrize("arch", ["yi_9b", "musicgen_large", "pixtral_12b"])
def test_make_batch_equals_reference(arch):
    _batches(arch, 3, 40, seed=11)
