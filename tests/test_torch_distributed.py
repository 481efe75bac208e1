"""The port's multi-device path (``distributed.compression``, the
placements of ``distributed.sharding``, the sharded bodies of
``models.moe``, ``launch.mesh``) against the reference's.

The codec is compared in this process, bit for bit.  Multi-rank results
are held against the reference's own multi-device run: the reference
runs in a subprocess whose environment alone carries a 4-device CPU
platform (``XLA_FLAGS``) with XLA's CPU client single-threaded, and
writes its outputs to an ``.npz``; the port runs as 4 spawned gloo
ranks (``file://`` rendezvous, one thread each) that write theirs.
Subprocess and ranks share one core at a lower priority (``_quiet``),
so the file loads the machine as a single-threaded one does.  Results are compared by mesh coordinate.  Each group of
cases has one reference subprocess and one spawned job, in module-scoped
fixtures.  This process never joins a process group.

Tolerances, per case: the codec bit-equal; the pod all-reduce's int32
sums exact, its new errors bit-equal, its decoded gradients bit-equal at
2 pods and within 1 ulp at 4 (the scales' float32 sum may run in
another order); the compressed train step at the atol 1e-4 (rtol 1e-5)
that ``tests/test_torch_train.py`` holds params to, for params, moments
and errors (but for quantizer flips, ``_assert_state_close``), and
metrics at its 1e-4 model tolerance; local shards equal;
the sharded MoE output at rel 1e-5, ``aux`` and ``zloss`` at 1e-6.

JAX is imported inside the tests and the reference's subprocesses."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _hyp import given, settings, st
from _multirank import (WORLD, _coord, _NamedMesh, _np, _ranks, _reference,
                        _spec_leaves, _unflatten)

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.distributed import compression as pt_comp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as pt_mesh

TRAIN_TOL = {"rtol": 1e-5, "atol": 1e-4}
METRIC_TOL = {"rtol": 1e-4, "atol": 1e-4}
MOE_TOL = {"rtol": 1e-5, "atol": 1e-6}
LOSS_TOL = {"rtol": 0, "atol": 1e-6}

POD_MESHES = ((2, 2), (4, 1))                 # (pods, data); model 1
TRAIN_MESHES = ((2, 1, 1), (2, 2, 1))         # (pod, data, model)
TRAIN_STEPS = 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PLACE_ARCHS = ("yi_9b", "deepseek_v2_lite_16b")
PLACE_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# leaves beside the models' whose axes' sizes do not divide them
UNEVEN = {"['uneven']['a']": ((6, 3), ("fsdp", "tp")),
          "['uneven']['b']": ((5, 4), ("dp", None))}
MOE_SMOKE = get_config("deepseek_v2_lite_16b", smoke=True).moe
MOE_CFS = (1.25, MOE_SMOKE.n_routed / MOE_SMOKE.top_k)
MOE_CASES = tuple((s, m, cf) for s, m in (("fsdp", "2x2"), ("tp_sp", "2x2"),
                                           ("megatron_sp", "2x2"),
                                           ("fsdp", "2x1x2"))
                  for cf in MOE_CFS)
MOE_X = (8, 32, 64)                           # B, S, d_model
X_LOGICAL = {"megatron_sp": ("dp", "act_seq", None)}
TOKEN_LOGICAL = ("tokens", None, None)


# --------------------------------------------------------------- helpers
def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to the nearest bf16 values, held in float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in float32 units in the last place."""
    def ordered(a):
        i = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
        return np.where(i < 0, np.int64(-2**31) - i, i).astype(np.int64)
    return int(np.abs(ordered(got) - ordered(want)).max(initial=0))


# ================================================================ codec
def _codec_pair(dtype: str, a: np.ndarray):
    import jax.numpy as jnp
    a = _bf16_exact(a) if dtype == "bf16" else a.astype(np.float32)
    pt = torch.from_numpy(a.copy())
    return (pt.to(torch.bfloat16) if dtype == "bf16" else pt,
            jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32))


def _ties(scale: float = 1.0) -> np.ndarray:
    """max|g| = 127 * scale, so s = scale and g / s hits .5 exactly."""
    v = [127, -127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5,
         0.0, 64.5, 100.5, 7.5, -8.5]
    return np.array(v, np.float32) * np.float32(scale)


CODEC_SHAPES = ((256,), (33, 7), (3, 4, 50))
SPECIAL = {
    "zeros": lambda rng: np.zeros((4, 8), np.float32),
    "ties": lambda rng: _ties(),
    "ties_pow2": lambda rng: _ties(2.0 ** -7),
    "at_127": lambda rng: np.array([1.0, -1.0, 0.25, -0.999, 0.0],
                                   np.float32),
    "tiny": lambda rng: rng.normal(size=(33,)).astype(np.float32) * 1e-30,
    "wide": lambda rng: (rng.normal(size=(5, 7)) * 10.0 ** rng.integers(
        -6, 6, (5, 7))).astype(np.float32),
}


@functools.cache
def _compiled(name: str):
    """The reference's codec function compiled, as its train step and
    grad sync run it (XLA turns ``/ 127.0`` into a multiply by
    float32(1/127) and fuses the residual's ``x - q * s``)."""
    import jax

    from repro.distributed import compression as ref
    return jax.jit(getattr(ref, name))


def _check_quantize(dtype: str, a: np.ndarray) -> None:
    from repro.distributed import compression as ref
    pt, jx = _codec_pair(dtype, a)
    q, s = pt_comp.quantize_int8(pt)
    rq, rs = _compiled("quantize_int8")(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert _np(s).tobytes() == np.asarray(rs, np.float32).tobytes()
    # the reference run eagerly divides by 127: its scale within 1 ulp
    assert _ulps(_np(s), np.asarray(ref.quantize_int8(jx)[1])) <= 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_quantize_bit_equal_to_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    shape = CODEC_SHAPES[rng.integers(len(CODEC_SHAPES))]   # few compiles
    a = (rng.normal(size=shape) * rng.uniform(1e-3, 1e3)).astype(np.float32)
    _check_quantize(dtype, a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_quantize_special_inputs_bit_equal(case, dtype):
    a = SPECIAL[case](np.random.default_rng(0))
    _check_quantize(dtype, a)
    if case == "zeros":
        _, s = pt_comp.quantize_int8(torch.from_numpy(a))
        assert float(s) == np.float32(1e-12)
    if case.startswith("ties"):
        q, _ = pt_comp.quantize_int8(torch.from_numpy(a))
        assert q[:3].tolist() == [127, -127, 0]       # 0.5 -> 0 (even)
        assert q[3:5].tolist() == [2, 2]              # 1.5, 2.5 -> 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compress_residual_and_dequantize_bit_equal(dtype):
    """Against the reference compiled, as its train step and grad sync
    run it: XLA fuses the residual's ``x - q * s`` into one rounding."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import compression as ref
    rng = np.random.default_rng(1)
    pt, jx = _codec_pair(dtype, rng.normal(size=(6, 50)).astype(np.float32))
    err = (rng.normal(size=(6, 50)) * 0.01).astype(np.float32)
    q, s, e = pt_comp.compress_residual(pt, torch.from_numpy(err))
    rq, rs, re_ = _compiled("compress_residual")(jx, jnp.asarray(err))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert _np(s).tobytes() == np.asarray(rs).tobytes()
    assert e.dtype == torch.float32
    assert e.numpy().tobytes() == np.asarray(re_).tobytes()
    for out in (torch.float32, torch.bfloat16):
        got = pt_comp.dequantize_int8(q, s, out)
        want = jax.jit(ref.dequantize_int8, static_argnums=2)(
            rq, rs, jnp.float32 if out == torch.float32 else jnp.bfloat16)
        assert got.dtype == out
        assert np.array_equal(_np(got), _np(want))


@given(st.integers(0, 5))
@settings(max_examples=10, deadline=None)
def test_quantize_error_bounded(seed):
    """``tests/test_distributed.py``'s bound on the port."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=256)
                         .astype(np.float32) * 3.0)
    q, s = pt_comp.quantize_int8(g)
    err = (pt_comp.dequantize_int8(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_recovers_mean_gradient():
    """With a constant gradient, the time-average of the decoded
    gradients converges to it (``tests/test_distributed.py``), and every
    step's decode and error equal the compiled reference's."""
    import jax.numpy as jnp

    from repro.distributed import compression as ref
    ref_step = _compiled("compress_residual")
    g = (np.random.default_rng(0).normal(size=128) * 0.1).astype(np.float32)
    err, rerr = torch.zeros(128), jnp.zeros(128, jnp.float32)
    total, rtotal = torch.zeros(128), np.zeros(128, np.float32)
    steps = 200
    for _ in range(steps):
        q, s, err = pt_comp.compress_residual(torch.from_numpy(g), err)
        rq, rs, rerr = ref_step(jnp.asarray(g), rerr)
        total = total + pt_comp.dequantize_int8(q, s)
        rtotal = rtotal + np.asarray(ref.dequantize_int8(rq, rs))
    np.testing.assert_allclose((total / steps).numpy(), g, atol=5e-4)
    assert total.numpy().tobytes() == np.asarray(rtotal).tobytes()
    assert err.numpy().tobytes() == np.asarray(rerr).tobytes()


def test_init_error_state_shapes():
    params = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": [torch.ones(2)]}
    err = pt_comp.init_error_state(params)
    assert err["a"].shape == (3, 4) and err["a"].dtype == torch.float32
    assert err["b"][0].shape == (2,) and not err["b"][0].any()


@pytest.mark.parametrize("arch", ["yi_9b", "deepseek_v2_lite_16b",
                                  "rwkv6_3b", "zamba2_2p7b"])
def test_abstract_compressed_state_equals_reference(arch):
    import jax

    from repro.configs import base as ref_base
    from repro.distributed import compression as ref
    from repro.models.archs import build_model as ref_build
    from repro.train import steps as ref_steps
    from repro_torch.models.archs import build_model
    from repro_torch.train import steps as pt_steps
    from jax.sharding import PartitionSpec as P

    rshapes, rspecs = ref.abstract_compressed_state(
        *ref_steps.abstract_train_state(
            ref_build(ref_base.get_config(arch, smoke=True))), n_pods=2)
    shapes, specs = pt_comp.abstract_compressed_state(
        *pt_steps.abstract_train_state(
            build_model(get_config(arch, smoke=True), device="cpu")),
        n_pods=2)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(rshapes["err"])[0]}
    got = dict(pytree.flatten_with_keys(shapes["err"]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta" and got[k].dtype == torch.float32
        assert tuple(got[k].shape) == tuple(w.shape) and w.shape[0] == 2
    want_specs = {jax.tree_util.keystr(k): tuple(v) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      rspecs["err"], is_leaf=lambda x: isinstance(x, P))[0]}
    assert dict(_spec_leaves(specs["err"])) == want_specs
    assert shapes["params"] is not None and specs["opt"] is not None


# ============================================== placements without ranks
def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _NamedMesh((2, 2, 2), ("pod", "data", "model"), (0, 1, 1))
    assert shd.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, (None, None)) == (Replicate(),) * 3
    assert shd.placements(mesh, ("data",)) == (Replicate(), Shard(0),
                                               Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="two dimensions"):
        shd.placements(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="no mesh axis"):
        shd.placements(mesh, ("rows",))


def test_local_shard_cuts_major_first_and_refuses_uneven():
    mesh = _NamedMesh((2, 3), ("data", "model"), (1, 2))
    x = torch.arange(36).reshape(12, 3)
    sh = shd.Sharding(mesh, shd.placements(mesh, (("data", "model"), None)))
    assert torch.equal(shd.local_shard(x, sh), x[10:12])   # chunk 1 * 3 + 2
    sh = shd.Sharding(mesh, shd.placements(mesh, ("data", "model")))
    assert torch.equal(shd.local_shard(x, sh), x[6:12, 2:3])
    with pytest.raises(ValueError, match="divide"):
        shd.local_shard(torch.zeros(8, 3), shd.Sharding(
            mesh, shd.placements(mesh, (("data", "model"), None))))


def test_hint_stays_the_identity_under_rules():
    x = torch.ones(2, 3)
    rules = shd.MeshRules(_NamedMesh((2,), ("data",), (0,)))
    with shd.use_rules(rules):
        assert shd.hint(x, "dp", None) is x
        with pytest.raises(ValueError, match="logical axis"):
            shd.hint(x, "rows", None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_a_small_world(multi_pod):
    import torch.distributed as dist
    assert not dist.is_initialized()
    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"need {n} ranks.*world size is 1"):
        pt_mesh.make_production_mesh(multi_pod=multi_pod)


def test_grad_sync_is_the_identity_without_a_pod_axis():
    rules = shd.MeshRules(_NamedMesh((2, 2), ("data", "model"), (0, 0)))
    sync = pt_comp.make_compressed_grad_sync(rules, {"w": ("fsdp", "tp")})
    g, e = {"w": torch.ones(2)}, {"w": torch.zeros(2)}
    assert sync(g, e) == (g, e)


@pytest.mark.parametrize("shape,names,match", [
    ((2, 1, 2), ("pod", "data", "model"), "tensor-parallel"),
    ((2, 2), ("data", "model"), "no 'pod' axis")])
def test_compressed_train_step_refuses_what_it_cannot_run(shape, names,
                                                          match):
    """On a model axis of 2 the step runs the attention families' tensor-
    parallel layers (``tests/test_torch_tp.py``); it refuses a recurrent
    model there, and a replicated state, which would quietly replicate
    the layers; a mesh without a pod axis is refused as before."""
    from repro_torch.models.archs import build_model
    from repro_torch.train.optimizer import OptConfig
    rules = shd.MeshRules(_NamedMesh(shape, names, (0,) * len(shape)))
    rwkv = build_model(get_config("rwkv6_3b", smoke=True), device="cpu")
    exc = NotImplementedError if match == "tensor-parallel" else ValueError
    with pytest.raises(exc, match=match):
        pt_comp.make_compressed_train_step(rwkv, None, rules)
    if exc is ValueError:
        return
    yi = build_model(get_config("yi_9b", smoke=True), device="cpu")
    step = pt_comp.make_compressed_train_step(yi, OptConfig(), rules)
    state = pt_comp.init_compressed_state(
        {"params": dict(yi.named_parameters())})
    with pytest.raises(ValueError, match="shard_train_state"):
        step(state, {})


def test_sharded_moe_refuses_autograd():
    """The sharded MoE bodies train (their collectives carry their
    adjoints), and the int8 KV cache's decode now splits its heads and
    combines a sequence-sharded softmax (``tests/test_torch_tp_ssm.py``
    holds it on ranks).  What it refuses is a head slice that the rules
    do not cut; under rules whose model axis is 1 it is the plain
    decode."""
    from repro_torch.models import attention as attn
    cfg = get_config("yi_9b", smoke=True)
    p = attn.init_attention(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    for w in p.values():
        with torch.no_grad():
            w.normal_(generator=g)
    B, S, K, hd = 2, 8, cfg.n_kv_heads, cfg.head_dim
    x = torch.randn((B, 1, cfg.d_model), generator=g)

    def caches():
        return [torch.zeros((B, S, K, hd), dtype=torch.int8)
                for _ in range(2)] + [torch.zeros((B, S, K))
                                      for _ in range(2)]
    with torch.no_grad():
        want = attn.gqa_decode_q8(cfg, p, x, 3, *[c.clone()
                                                  for c in caches()])
        rules = shd.MeshRules(_NamedMesh((2, 1), ("data", "model"), (1, 0)),
                              strategy="tp_sp")
        with shd.use_rules(rules):
            got = attn.gqa_decode_q8(cfg, p, x, 3, *[c.clone()
                                                     for c in caches()])
            half = dict(p, wq=p["wq"][:, :cfg.n_heads // 2],
                        wo=p["wo"][:cfg.n_heads // 2])
            with pytest.raises(ValueError, match="slice"):
                attn.gqa_decode_q8(cfg, half, x, 3, *caches())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ============================================= 1. the pod all-reduce
POD_LEAVES = ("f32_normal", "f32_ties", "f32_zeros", "f32_big",
              "bf16_normal")


def _pod_inputs() -> dict:
    rng = np.random.default_rng(11)
    out = {}
    for pods, data in POD_MESHES:
        lead = (pods, data)
        g = {"f32_normal": rng.normal(size=(*lead, 64)) * 3.0,
             "f32_ties": np.stack([np.stack([_ties(2.0 ** (i - j))
                                             for j in range(data)])
                                   for i in range(pods)]),
             "f32_zeros": np.zeros((*lead, 4, 4)),
             "f32_big": rng.normal(size=(*lead, 2048)),
             "bf16_normal": _bf16_exact(
                 rng.normal(size=(*lead, 8, 16)).astype(np.float32))}
        for n, a in g.items():
            quiet = n in ("f32_ties", "f32_zeros")
            out[f"{pods}/{n}/g"] = a.astype(np.float32)
            out[f"{pods}/{n}/e"] = (np.zeros(a.shape) if quiet else
                                    rng.normal(size=a.shape) * 0.02
                                    ).astype(np.float32)
    return out


PROG_POD = """
from jax.experimental.shard_map import shard_map
from repro.distributed import compression as comp
from repro.distributed import sharding as shd
inp = np.load(TMP / "inputs.npz")
for pods, data in POD_MESHES:
    mesh = mesh_of((pods, data, 1), ("pod", "data", "model"))
    rules = shd.MeshRules(mesh)
    dt = lambda n: jnp.bfloat16 if n.startswith("bf16") else jnp.float32
    g = {n: jnp.asarray(inp[f"{pods}/{n}/g"], dt(n)) for n in POD_LEAVES}
    e = {n: jnp.asarray(inp[f"{pods}/{n}/e"]) for n in POD_LEAVES}
    specs = {n: P("pod", "data", *[None] * (g[n].ndim - 2)) for n in g}
    new_g, new_e = jax.jit(comp.make_compressed_grad_sync(rules, specs))(g, e)

    def sums(g, e):
        return {n: jax.lax.psum(comp.compress_residual(g[n], e[n])[0]
                                .astype(jnp.int32), "pod") for n in g}

    tot = jax.jit(shard_map(sums, mesh=mesh, in_specs=(specs, specs),
                            out_specs=specs, check_rep=False))(g, e)
    for n in POD_LEAVES:
        OUT[f"{pods}/{n}/g"] = host(new_g[n])
        OUT[f"{pods}/{n}/e"] = host(new_e[n])
        OUT[f"{pods}/{n}/tot"] = host(tot[n])
"""


def _job_pod(rank: int, tmp: Path) -> dict:
    inp = np.load(tmp / "inputs.npz")
    out = {}
    for pods, data in POD_MESHES:
        mesh = pt_mesh.make_smoke_mesh((pods, data, 1),
                                       ("pod", "data", "model"), "cpu")
        rules = shd.MeshRules(mesh)
        g, e, specs = {}, {}, {}
        for n in POD_LEAVES:
            whole = torch.from_numpy(inp[f"{pods}/{n}/g"])
            specs[n] = ("pod", "data", *[None] * (whole.ndim - 2))
            sh = rules.sharding(*specs[n])
            g[n] = shd.local_shard(whole, sh)
            if n.startswith("bf16"):
                g[n] = g[n].to(torch.bfloat16)
            e[n] = shd.local_shard(torch.from_numpy(inp[f"{pods}/{n}/e"]), sh)
        new_g, new_e = pt_comp.make_compressed_grad_sync(rules, specs)(g, e)
        _, _, sums = pt_comp._pod_allreduce(g, e, rules, keep_sums=True)
        for n in POD_LEAVES:
            assert new_g[n].dtype == g[n].dtype
            out[f"{pods}/{n}/g"] = _np(new_g[n])
            out[f"{pods}/{n}/e"] = _np(new_e[n])
            out[f"{pods}/{n}/tot"] = sums[n][0].numpy()
        out[f"{pods}/coord"] = np.array(mesh.get_coordinate())
    for multi in (False, True):
        try:
            pt_mesh.make_production_mesh(multi_pod=multi, device_type="cpu")
            out[f"production/{multi}"] = np.array("built")
        except RuntimeError as exc:
            out[f"production/{multi}"] = np.array(str(exc))
    return out


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    np.savez(tmp / "inputs.npz", **_pod_inputs())
    return _reference(PROG_POD, tmp, POD_MESHES=POD_MESHES,
                      POD_LEAVES=POD_LEAVES), _ranks(_job_pod, tmp)


@pytest.mark.parametrize("what", ["tot", "e", "g"])
@pytest.mark.parametrize("pods", [p for p, _ in POD_MESHES])
def test_pod_allreduce_equals_reference(pod_run, pods, what):
    ref, ranks = pod_run
    for res in ranks:
        p, d, _ = res[f"{pods}/coord"]
        for n in POD_LEAVES:
            got = res[f"{pods}/{n}/{what}"]
            want = ref[f"{pods}/{n}/{what}"][p:p + 1, d:d + 1]
            assert got.shape == want.shape, n
            if what == "g" and pods > 2:
                assert _ulps(got, want) <= 1, n
            else:
                assert got.tobytes() == want.tobytes(), (n, what)


def test_pod_allreduce_ranks_agree_and_ties_round_to_even(pod_run):
    _, ranks = pod_run
    for pods, data in POD_MESHES:
        by_data = {}
        for res in ranks:
            p, d, _ = res[f"{pods}/coord"]
            by_data.setdefault(d, []).append(res)
        for group in by_data.values():         # the pod group's ranks
            for n in POD_LEAVES:
                for what in ("g", "tot"):
                    first = group[0][f"{pods}/{n}/{what}"]
                    assert all(np.array_equal(r[f"{pods}/{n}/{what}"], first)
                               for r in group), (pods, n, what)
    # 2 pods x 2 data ranks of _ties(2^(i-j)): the scale is 2^(i-j)
    # and every rank's q is the same round-half-to-even vector
    res = ranks[0]
    q = np.round(_ties())
    assert np.array_equal(res["2/f32_ties/tot"].reshape(-1), 2 * q)


def test_production_mesh_refuses_a_four_rank_world(pod_run):
    _, ranks = pod_run
    for res in ranks:
        for multi, n in ((False, 256), (True, 512)):
            msg = str(res[f"production/{multi}"])
            assert f"need {n} ranks" in msg and "world size is 4" in msg


# ============================================== 2. the compressed step
PROG_TRAIN = """
from repro.configs import base
from repro.distributed import compression as comp
from repro.distributed import sharding as shd
from repro.models import inputs
from repro.models.archs import build_model
from repro.train import optimizer as opt
from repro.train import steps
cfg = base.get_config("yi_9b", smoke=True)
model = build_model(cfg, remat="none")
state = jax.jit(lambda k: steps.init_train_state(model, k))(
    jax.random.PRNGKey(1))
for k, v in keyed(jax.device_get(state)).items():
    OUT["init" + k] = host(v)
for shape in TRAIN_MESHES:
    tag = "x".join(map(str, shape))
    rules = shd.MeshRules(mesh_of(shape, ("pod", "data", "model")),
                          strategy="megatron_sp")
    st = comp.init_compressed_state(state, shape[0])
    step = jax.jit(comp.make_compressed_train_step(
        model, opt.OptConfig(**TRAIN_OPT), rules))
    for i in range(TRAIN_STEPS):
        st, m = step(st, inputs.make_batch(cfg, 4, 32, seed=20 + i))
        for k, v in m.items():
            OUT[f"{tag}/m{i}/{k}"] = host(v)
    for k, v in keyed(jax.device_get(st)).items():
        OUT[f"{tag}/state{k}"] = host(v)
"""


def _job_train(rank: int, tmp: Path) -> dict:
    from repro_torch.models import inputs as pt_inputs
    from repro_torch.models import transformer as pt_tr
    from repro_torch.models.archs import build_model
    from repro_torch.train.optimizer import OptConfig

    with np.load(tmp / "ref.npz") as z:
        init = _unflatten({k[4:]: z[k] for k in z.files
                           if k.startswith("init")})
    cfg = get_config("yi_9b", smoke=True)
    out = {}
    for shape in TRAIN_MESHES:
        tag = "x".join(map(str, shape))
        if len(shape) and np.prod(shape) < WORLD:   # replicas of the mesh
            rep = WORLD // int(np.prod(shape))
            mesh = pt_mesh.make_smoke_mesh(
                (rep, *shape), ("rep", "pod", "data", "model"), "cpu")[
                    "pod", "data", "model"]
        else:
            mesh = pt_mesh.make_smoke_mesh(shape, ("pod", "data", "model"),
                                           "cpu")
        rules = shd.MeshRules(mesh, strategy="megatron_sp")
        model = build_model(cfg, remat="none", device="cpu")
        state = pt_comp.init_compressed_state(
            pt_tr.train_state_from_reference(model, init))
        step = pt_comp.make_compressed_train_step(model,
                                                  OptConfig(**TRAIN_OPT),
                                                  rules)
        for i in range(TRAIN_STEPS):
            whole = pt_inputs.make_batch(cfg, 4, 32, seed=20 + i,
                                         device="cpu")
            batch = {k: shd.local_shard(v, rules.sharding("dp", None))
                     for k, v in whole.items()}
            state, m = step(state, batch)
            for k, v in m.items():
                out[f"{tag}/m{i}/{k}"] = _np(v)
        tree = pt_tr.train_state_to_reference(state)
        tree["err"] = pt_tr._reference_tree(
            {n: e[0] for n, e in state["err"].items()})
        for k, v in pytree.flatten_with_keys(tree):
            out[f"{tag}/state{k}"] = _np(v)
        out[f"{tag}/coord"] = np.array(mesh.get_coordinate())
    return out


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    ref = _reference(PROG_TRAIN, tmp, TRAIN_MESHES=TRAIN_MESHES,
                     TRAIN_STEPS=TRAIN_STEPS, TRAIN_OPT=TRAIN_OPT)
    return ref, _ranks(_job_train, tmp)


def _assert_state_close(got: np.ndarray, want: np.ndarray, key: str,
                        flip: float) -> None:
    """A state leaf at ``TRAIN_TOL``, but for quantizer flips: where the
    port's and the reference's float32 gradients (equal within 1e-4,
    not bit for bit) put x / s on either side of a .5 boundary, q
    differs by one.  That element's error then differs by one
    quantization step s (at that step and, through the error feedback,
    up to s at the next), and its decoded gradient by s / n, which
    AdamW, whose update is about +-lr a step here, can turn into up to
    2 lr a step on the parameter.  So at most one element in a thousand
    may leave the tolerance (measured: 1-4 of 16,384-81,920 a leaf), and
    by no more than ``flip``."""
    bad = ~np.isclose(got, want, **TRAIN_TOL)
    diff = np.abs(got - want)[bad]
    assert (diff <= flip).all(), (key, diff.max(), flip)
    assert bad.sum() <= max(1, got.size // 1000), (key, bad.sum())


@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_compressed_train_step_state_equals_reference(train_run, shape):
    """Params, moments and the pod's error block after two steps."""
    ref, ranks = train_run
    tag = "x".join(map(str, shape))
    for res in ranks:
        pod = int(res[f"{tag}/coord"][0])
        keys = sorted(k for k in res if k.startswith(f"{tag}/state"))
        assert keys == sorted(k for k in ref if k.startswith(f"{tag}/state"))
        for k in keys:
            part = k[len(f"{tag}/state"):].split("]")[0]
            if part == "['err'":     # one step: 2 max|e| <= s
                want = ref[k][pod]
                step = 2 * max(np.abs(res[k]).max(), np.abs(want).max())
                _assert_state_close(res[k], want, k, step * 1.01)
            elif part == "['params'":
                _assert_state_close(res[k], ref[k], k, 2 * TRAIN_OPT["lr"]
                                    * TRAIN_STEPS)
            else:
                np.testing.assert_allclose(res[k], ref[k], **TRAIN_TOL,
                                           err_msg=k)
        assert int(res[f"{tag}/state['opt']['step']"]) == TRAIN_STEPS


@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_compressed_train_step_metrics_equal_reference(train_run, shape):
    ref, ranks = train_run
    tag = "x".join(map(str, shape))
    for res in ranks:
        for i in range(TRAIN_STEPS):
            names = sorted(k.split("/")[-1] for k in res
                           if k.startswith(f"{tag}/m{i}/"))
            assert names == sorted(k.split("/")[-1] for k in ref
                                   if k.startswith(f"{tag}/m{i}/"))
            for n in names:
                got, want = res[f"{tag}/m{i}/{n}"], ref[f"{tag}/m{i}/{n}"]
                if n in ("step", "tokens"):
                    assert float(got) == float(want), n
                else:
                    np.testing.assert_allclose(got, want, **METRIC_TOL,
                                               err_msg=n)


@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_compressed_train_step_keeps_params_equal_across_ranks(train_run,
                                                               shape):
    """Every rank decodes the same sums: params and moments bit-equal;
    the error blocks equal within a pod."""
    _, ranks = train_run
    tag = "x".join(map(str, shape))
    first = ranks[0]
    for res in ranks[1:]:
        for k in res:
            if k.startswith(f"{tag}/state") and "['err']" not in k:
                assert res[k].tobytes() == first[k].tobytes(), k
    pods = {}
    for res in ranks:
        pods.setdefault(int(res[f"{tag}/coord"][0]), []).append(res)
    assert len(pods) == 2
    for group in pods.values():
        for k in group[0]:
            if k.startswith(f"{tag}/state['err']"):
                assert all(r[k].tobytes() == group[0][k].tobytes()
                           for r in group), k


# ================================================== 3. the placements
PROG_PLACE = """
from repro.configs import base
from repro.distributed import sharding as shd
from repro.models.archs import build_model
for arch in PLACE_ARCHS:
    model = build_model(base.get_config(arch, smoke=True))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))   # one compile
    specs = model.abstract()[1]
    flat, flat_specs = keyed(params), keyed(specs)
    for k, (shape, spec) in UNEVEN.items():
        flat[k] = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
        flat_specs[k] = P(*spec)
    for k, v in flat.items():
        OUT[f"{arch}/full{k}"] = host(v)
    for mname, (shape, names) in PLACE_MESHES.items():
        mesh = mesh_of(shape, names)
        for strategy in shd.STRATEGIES:
            rules = shd.MeshRules(mesh, strategy=strategy)
            placed = {}
            for k, x in flat.items():
                try:
                    placed[k] = jax.device_put(
                        x, rules.sharding(*flat_specs[k]))
                except ValueError:
                    OUT[f"{arch}/{mname}/{strategy}{k}/refused"] = \
                        np.array(True)
            for k, arr in placed.items():
                for s in arr.addressable_shards:
                    OUT[f"{arch}/{mname}/{strategy}{k}/"
                        f"{coord(mesh, s.device)}"] = host(s.data)
"""


def _job_place(rank: int, tmp: Path) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.archs import build_model

    ref = np.load(tmp / "ref.npz")
    out = {}
    meshes = {m: pt_mesh.make_smoke_mesh(shape, names, "cpu")
              for m, (shape, names) in PLACE_MESHES.items()}
    for arch in PLACE_ARCHS:
        _, specs = build_model(get_config(arch, smoke=True),
                               device="cpu").abstract()
        for mname, mesh in meshes.items():
            c = _coord(mesh.get_coordinate())
            for strategy in shd.STRATEGIES:
                rules = shd.MeshRules(mesh, strategy=strategy)
                leaves = dict(_spec_leaves(specs))
                leaves.update({k: spec for k, (_, spec) in UNEVEN.items()})
                resolved = {k: rules.spec(*s) for k, s in leaves.items()}
                shardings = shd.spec_tree_to_shardings(rules, resolved)
                for k, sh in shardings.items():
                    tag = f"{arch}/{mname}/{strategy}{k}"
                    whole = torch.from_numpy(ref[f"{arch}/full{k}"])
                    try:
                        local = shd.local_shard(whole, sh)
                    except ValueError:
                        out[tag + "/refused"] = np.array(True)
                        continue
                    dt = distribute_tensor(whole, *sh, src_data_rank=None)
                    assert torch.equal(dt.to_local(), local), tag
                    out[f"{tag}/{c}"] = local.numpy()
    return out


@pytest.fixture(scope="module")
def place_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("place")
    ref = _reference(PROG_PLACE, tmp, PLACE_ARCHS=PLACE_ARCHS,
                     PLACE_MESHES=PLACE_MESHES, UNEVEN=UNEVEN)
    return ref, _ranks(_job_place, tmp)


@pytest.mark.parametrize("strategy", shd.STRATEGIES)
@pytest.mark.parametrize("mname", sorted(PLACE_MESHES))
@pytest.mark.parametrize("arch", PLACE_ARCHS)
def test_local_shards_equal_reference_at_every_coordinate(place_run, arch,
                                                          mname, strategy):
    ref, ranks = place_run
    prefix = f"{arch}/{mname}/{strategy}"
    want = {k: v for k, v in ref.items() if k.startswith(prefix)}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items() if k.startswith(prefix)})
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/refused") for k in want) or len(want) > 0
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k


def test_placements_shard_something_on_each_mesh(place_run):
    """The cases above are not vacuous: on each mesh some leaf is split
    on two mesh axes at once and some (``UNEVEN``) is refused."""
    ref, _ = place_run
    for arch in PLACE_ARCHS:
        for mname in PLACE_MESHES:
            split = refused = 0
            for k, v in ref.items():
                m = re.fullmatch(rf"{arch}/{mname}/fsdp(\[.*\])/([\d,]+)", k)
                if m and v.size * 4 == ref[f"{arch}/full{m.group(1)}"].size:
                    split += 1
                refused += k.startswith(f"{arch}/{mname}/") \
                    and k.endswith("/refused")
            assert split and refused, (arch, mname, split, refused)


# ============================================ 4. the sharded MoE bodies
def _moe_x() -> np.ndarray:
    """Tokens around one direction, so the router prefers a few experts
    and capacity 1.25 drops some."""
    rng = np.random.default_rng(5)
    lean = rng.normal(size=MOE_X[-1])
    return (rng.normal(size=MOE_X) * 0.5 + lean).astype(np.float32)


PROG_MOE = """
import dataclasses
from repro.configs import base
from repro.distributed import sharding as shd
from repro.models import moe
cfg0 = base.get_config("deepseek_v2_lite_16b", smoke=True)
params = jax.jit(lambda k: moe.init_moe(k, cfg0)[0])(jax.random.PRNGKey(3))
for k, v in params.items():
    OUT[f"p/{k}"] = host(v)
x = jnp.asarray(np.load(TMP / "inputs.npz")["x"])
for strategy, mname, cf in MOE_CASES:
    shape, names = MESHES[mname]
    mesh = mesh_of(shape, names)
    rules = shd.MeshRules(mesh, strategy=strategy)

    def cfg_with(**kw):
        return dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, capacity_factor=cf, **kw))

    c_all = cfg_with()
    c_aux, c_z = cfg_with(router_z_coef=0.0), cfg_with(aux_loss_coef=0.0)
    with shd.use_rules(rules):
        out, total, aux, z = jax.jit(lambda p, x: (
            *moe.moe_ffn(c_all, p, x), moe.moe_ffn(c_aux, p, x)[1],
            moe.moe_ffn(c_z, p, x)[1]))(params, x)
    tag = f"{strategy}/{mname}/{cf}"
    xs = X_LOGICAL.get(strategy, TOKEN_LOGICAL)
    arr = jax.device_put(out, NamedSharding(mesh, rules.spec(*xs)))
    for s in arr.addressable_shards:
        OUT[f"{tag}/out/{coord(mesh, s.device)}"] = host(s.data)
    OUT[f"{tag}/total"], OUT[f"{tag}/aux"], OUT[f"{tag}/zloss"] = (
        host(total), host(aux), host(z))
"""


def _job_moe(rank: int, tmp: Path) -> dict:
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.transformer import PARAM_SPECS

    ref = np.load(tmp / "ref.npz")
    x = torch.from_numpy(np.load(tmp / "inputs.npz")["x"])
    cfg0 = get_config("deepseek_v2_lite_16b", smoke=True)
    meshes = {m: pt_mesh.make_smoke_mesh(shape, names, "cpu")
              for m, (shape, names) in PLACE_MESHES.items()}
    out = {}
    for strategy, mname, cf in MOE_CASES:
        mesh = meshes[mname]
        rules = shd.MeshRules(mesh, strategy=strategy)

        def cfg_with(**kw):
            return dataclasses.replace(cfg0, moe=dataclasses.replace(
                cfg0.moe, capacity_factor=cf, **kw))

        p = {k[2:]: shd.local_shard(torch.from_numpy(ref[k]), rules.sharding(
            *PARAM_SPECS[("moe", k[2:])])) for k in ref.files
            if k.startswith("p/")}
        xs = shd.local_shard(x, rules.sharding(
            *X_LOGICAL.get(strategy, TOKEN_LOGICAL)))
        tag = f"{strategy}/{mname}/{cf}"
        with shd.use_rules(rules), torch.no_grad():
            y, total = moe.moe_ffn(cfg_with(), p, xs)
            aux = moe.moe_ffn(cfg_with(router_z_coef=0.0), p, xs)[1]
            z = moe.moe_ffn(cfg_with(aux_loss_coef=0.0), p, xs)[1]
        out[f"{tag}/out/{_coord(mesh.get_coordinate())}"] = y.numpy()
        out[f"{tag}/x/{_coord(mesh.get_coordinate())}"] = xs.numpy()
        out[f"{tag}/total"], out[f"{tag}/aux"], out[f"{tag}/zloss"] = (
            total.numpy(), aux.numpy(), z.numpy())
    return out


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    np.savez(tmp / "inputs.npz", x=_moe_x())
    ref = _reference(PROG_MOE, tmp, MOE_CASES=MOE_CASES,
                     MESHES=PLACE_MESHES, X_LOGICAL=X_LOGICAL,
                     TOKEN_LOGICAL=TOKEN_LOGICAL)
    return ref, _ranks(_job_moe, tmp)


@pytest.mark.parametrize("strategy,mname,cf", MOE_CASES)
def test_sharded_moe_equals_reference(moe_run, strategy, mname, cf):
    ref, ranks = moe_run
    tag = f"{strategy}/{mname}/{cf}"
    for res in ranks:
        [key] = [k for k in res if k.startswith(f"{tag}/out/")]
        np.testing.assert_allclose(res[key], ref[key], **MOE_TOL)
        for k in ("aux", "zloss", "total"):
            np.testing.assert_allclose(res[f"{tag}/{k}"], ref[f"{tag}/{k}"],
                                       **LOSS_TOL, err_msg=k)


def test_sharded_moe_drops_tokens_at_capacity_1_25(moe_run):
    """At capacity factor 1.25 some rank drops routed slots (each rank's
    capacity comes from its own token count); at n_routed / top_k none
    does."""
    from repro_torch.models import moe

    ref, ranks = moe_run
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    router = torch.from_numpy(ref["p/router"])
    for strategy, mname, cf in MOE_CASES:
        tag = f"{strategy}/{mname}/{cf}"
        dropped = 0
        for res in ranks:
            [key] = [k for k in res if k.startswith(f"{tag}/x/")]
            x = torch.from_numpy(res[key])
            if strategy == "megatron_sp":      # the body sees the whole S
                continue
            x = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(x @ router, dim=-1)
            idx = moe._top_k(probs, cfg.moe.top_k)[1]
            counts = torch.bincount(idx.reshape(-1),
                                    minlength=cfg.moe.n_routed)
            c = moe._capacity(x.shape[0], _with_cf(cfg, cf))
            dropped += int((counts - c).clamp_min(0).sum())
        if strategy != "megatron_sp":
            assert (dropped > 0) == (cf == 1.25), (tag, dropped)


def _with_cf(cfg, cf):
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


# ================================================================ card
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_on_the_card_equals_cpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(1 << 20,)).astype(np.float32)
                         ).to(dtype)
    g[:16] = torch.from_numpy(_ties()).to(dtype)
    e = torch.from_numpy(rng.normal(size=(1 << 20,)).astype(np.float32)
                         * 0.01)
    want = pt_comp.compress_residual(g, e)
    got = pt_comp.compress_residual(g.cuda(), e.cuda())
    for w, o in zip(want, got):
        assert torch.equal(o.cpu(), w)
