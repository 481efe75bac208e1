"""FSDP execution of the port's train step (``train.steps.
shard_train_state``, ``sharding.gathered`` / ``GatherParam``,
``inputs.shard_batch``, the compressed step over an FSDP state) against
the reference's sharded step on the same mesh.

The reference runs in one subprocess on a 4-device CPU platform (the
``tests/_multirank.py`` harness): ``make_train_step`` (or
``make_compressed_train_step``) under ``jax.jit(in_shardings=...)`` and
``use_rules(rules)``, the shardings from its own ``resolve_tree``, as
``launch/dryrun.py::build_cell`` builds a train cell.  ``repro.launch.
dryrun`` sets ``XLA_FLAGS`` on import, so the subprocess imports it only
after ``jax.devices()`` has started the 4-device backend.  The port runs
the same cases as 4 spawned gloo ranks, each rank cutting its blocks
from the reference's seeded initial state (the reference's step is
compiled once a case, its state placed on its shardings first).  Each
group (the reference, the ranks)
runs in one module-scoped fixture; this process never joins a process
group.

Cases, 2 steps each at lr 1e-3 on float32 smoke configs: yi_9b under
``fsdp`` on (data 2, model 2); pixtral_12b (patches and tokens) under
``fsdp`` on (data 4, model 1); deepseek_v2_lite_16b under ``fsdp`` on
(data 2, model 2) at capacity factors 1.25 and n_routed / top_k;
rwkv6_3b under ``fsdp_dp`` on (pod 2, data 1, model 2) with 2
micro-batches; zamba2_2p7b under ``fsdp_dp`` on (pod 2, data 1, model
2); the compressed step of rwkv6_3b over an ``fsdp_dp`` state on (pod 2,
data 2, model 1).

Tolerances: the gathered params and moments at ``TRAIN_TOL`` (atol
1e-4, rtol 1e-5, as ``tests/test_torch_distributed.py`` holds the
compressed step), the compressed step's params and errors but for
quantizer flips (its ``_assert_state_close``), zamba2_2p7b's moments
within the reference's own spread (``_leaf_check`` says why); each rank's blocks by the same rule against
the reference's shard at its coordinate, their shapes equal; metrics at
``METRIC_TOL``, ``step`` and ``tokens`` exact, and bit-equal across
ranks.  ``fit_spec`` and ``resolve_tree`` equal
the reference's ``_fit_spec`` / ``resolve_tree`` exactly."""

import dataclasses

import numpy as np
import pytest
import torch
from _multirank import (_block_state, _block_tree, _coord, _NamedMesh, _np,
                        _ranks, _reference, _spec_leaves, _unflatten)

from repro_torch import pytree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import inputs as pt_inputs
from repro_torch.models.archs import build_model
from repro_torch.train import steps as pt_steps
from test_torch_distributed import (METRIC_TOL, MOE_CFS, PLACE_MESHES,
                                    TRAIN_TOL, UNEVEN)
from test_torch_ssm import GRAD_NORM_RTOL, ZAMBA

STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 32
MESH3 = ("pod", "data", "model")
MESH2 = ("data", "model")
# tag: (arch, strategy, mesh shape, mesh names, micro-batches, capacity
# factor, compressed)
CASES = {
    "yi_9b/fsdp": ("yi_9b", "fsdp", (2, 2), MESH2, 1, None, False),
    "pixtral_12b/fsdp": ("pixtral_12b", "fsdp", (4, 1), MESH2, 1, None,
                         False),
    **{f"deepseek_v2_lite_16b/fsdp/{cf}": (
        "deepseek_v2_lite_16b", "fsdp", (2, 2), MESH2, 1, cf, False)
       for cf in MOE_CFS},
    "rwkv6_3b/fsdp_dp": ("rwkv6_3b", "fsdp_dp", (2, 1, 2), MESH3, 2, None,
                         False),
    "zamba2_2p7b/fsdp_dp": ("zamba2_2p7b", "fsdp_dp", (2, 1, 2), MESH3, 1,
                            None, False),
    "rwkv6_3b/compressed": ("rwkv6_3b", "fsdp_dp", (2, 2, 1), MESH3, 1,
                            None, True),
}
ARCHS = sorted({c[0] for c in CASES.values()})
ZAMBA_SPREAD = 0.11     # of a moment leaf's largest entry (_leaf_check)
ZAMBA_OUTLIERS = 0.011  # of a param leaf's entries outside TRAIN_TOL
CORE = -2       # the next-to-last core: tests/test_torch_distributed.py's is the last


# ------------------------------------------------- the reference's run
PROG = """
import dataclasses
assert len(jax.devices()) == 4
from repro.launch.dryrun import _fit_spec, resolve_tree   # after the backend
assert jax.device_count() == 4
from repro.configs import base
from repro.distributed import compression as comp
from repro.distributed import sharding as shd
from repro.models import inputs
from repro.models.archs import build_model
from repro.train import optimizer as opt
from repro.train import steps

# fitted specs of every arch's smoke tree, and the uneven leaves
for arch in FIT_ARCHS:
    shapes, specs = build_model(base.get_config(arch, smoke=True)).abstract()
    flat_shapes, flat_specs = keyed(shapes), keyed(specs)
    for k, (shape, spec) in UNEVEN.items():
        flat_shapes[k] = jax.ShapeDtypeStruct(shape, jnp.float32)
        flat_specs[k] = P(*spec)
    for mname, (shape, names) in MESHES.items():
        mesh = mesh_of(shape, names)
        for strategy in shd.STRATEGIES:
            rules = shd.MeshRules(mesh, strategy=strategy)
            fits = resolve_tree(rules, flat_specs, flat_shapes)
            for k, sh in fits.items():
                spec = tuple(sh.spec)
                assert spec == tuple(_fit_spec(
                    rules, rules.spec(*flat_specs[k]), flat_shapes[k].shape))
                OUT[f"fit/{arch}/{mname}/{strategy}{k}"] = np.array(
                    repr(spec))

inits = {}
for tag, (arch, strategy, shape, names, micro, cf, compressed) in CASES.items():
    cfg = base.get_config(arch, smoke=True)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    model = build_model(cfg, remat="full")
    if arch not in inits:
        inits[arch] = jax.jit(lambda k: steps.init_train_state(model, k))(
            jax.random.PRNGKey(1))
        for k, v in keyed(jax.device_get(inits[arch])).items():
            OUT[f"init/{arch}" + k] = host(v)
    mesh = mesh_of(shape, names)
    rules = shd.MeshRules(mesh, strategy=strategy)
    state = inits[arch]
    shapes, specs = steps.abstract_train_state(model, cfg.opt_dtype)
    o = opt.OptConfig(**OPT)
    if compressed:
        step = comp.make_compressed_train_step(model, o, rules)
        shapes, specs = comp.abstract_compressed_state(shapes, specs,
                                                       n_pods=shape[0])
        state = comp.init_compressed_state(state, shape[0])
    else:
        step = steps.make_train_step(model, o, microbatches=micro)
    batch_specs = inputs.train_input_specs(
        cfg, base.ShapeSpec("t", SEQ, BATCH, "train"))[1]
    in_sh = (resolve_tree(rules, specs, shapes),
             resolve_tree(rules, batch_specs))
    fn = jax.jit(step, in_shardings=in_sh, out_shardings=(in_sh[0], None))
    state = jax.device_put(state, in_sh[0])     # one compile for both steps
    with shd.use_rules(rules):
        for i in range(STEPS):
            state, m = fn(state, inputs.make_batch(cfg, BATCH, SEQ,
                                                    seed=20 + i))
            for k, v in m.items():
                OUT[f"{tag}/m{i}/{k}"] = host(v)
    for k, arr in keyed(state).items():
        OUT[f"{tag}/state{k}"] = host(jax.device_get(arr))
        for s in arr.addressable_shards:
            OUT[f"{tag}/local{k}/{coord(mesh, s.device)}"] = host(s.data)
"""


# ------------------------------------------------------ the port's ranks
def _job_fsdp(rank: int, tmp) -> dict:
    from repro_torch.distributed import compression as pt_comp
    from repro_torch.launch import mesh as pt_mesh
    from repro_torch.models import transformer as pt_tr
    from repro_torch.train.optimizer import OptConfig

    with np.load(tmp / "ref.npz") as z:
        inits = {arch: _unflatten({k[len(f"init/{arch}"):]: z[k]
                                   for k in z.files
                                   if k.startswith(f"init/{arch}[")})
                 for arch in ARCHS}
    out = {}
    for tag, (arch, strategy, shape, names, micro, cf,
              compressed) in CASES.items():
        cfg = _cfg(arch, cf)
        mesh = pt_mesh.make_smoke_mesh(shape, names, "cpu")
        rules = shd.MeshRules(mesh, strategy=strategy)
        model = build_model(cfg, remat="full", device="cpu")
        state = pt_tr.train_state_from_reference(model, inits[arch])
        state = pt_steps.shard_train_state(model, state, rules)
        o = OptConfig(**OPT)
        if compressed:
            state = pt_comp.init_compressed_state(state, rules)
            step = pt_comp.make_compressed_train_step(model, o, rules)
        else:
            step = pt_steps.make_train_step(model, o, microbatches=micro)
        shd.reset_collective_bytes()
        with shd.use_rules(rules):
            for i in range(STEPS):
                whole = pt_inputs.make_batch(cfg, BATCH, SEQ, seed=20 + i,
                                             device="cpu")
                state, m = step(state, pt_inputs.shard_batch(whole, rules,
                                                             micro))
                for k, v in m.items():
                    out[f"{tag}/m{i}/{k}"] = _np(v)
        for k, v in shd.COLLECTIVE_BYTES.items():
            out[f"{tag}/bytes/{k}"] = np.array(v)
        c = _coord(mesh.get_coordinate())
        local = _block_state(state)
        shapes, specs = pt_steps.abstract_train_state(model)
        whole = pt_tr.sharded_state_to_reference(state, rules, writer=True)
        if compressed:
            err = pt_tr._reference_tree({n: e[0]
                                         for n, e in state["err"].items()})
            pod_rules = dataclasses.replace(rules, manual_axes=("pod",))
            whole["err"] = shd.gather_tree(err, specs["params"],
                                           shapes["params"], pod_rules)
            local["err"] = pytree.map_with_keys(lambda _, e: e[None], err)
        for k, v in pytree.flatten_with_keys(whole):
            out[f"{tag}/state{k}"] = _np(v)
        for k, v in pytree.flatten_with_keys(local):
            out[f"{tag}/local{k}/{c}"] = _np(v)
        out[f"{tag}/coord"] = np.array(mesh.get_coordinate())
    return out


def _cfg(arch: str, cf):
    cfg = get_config(arch, smoke=True)
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    ref = _reference(PROG, tmp, core=CORE, CASES=CASES, STEPS=STEPS, OPT=OPT,
                     BATCH=BATCH, SEQ=SEQ, FIT_ARCHS=ARCH_IDS,
                     MESHES=PLACE_MESHES, UNEVEN=UNEVEN)
    return ref, _ranks(_job_fsdp, tmp, CORE)


# ======================================================= the fitted specs
@pytest.mark.parametrize("mname", sorted(PLACE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fit_spec_and_resolve_tree_equal_reference(fsdp_run, arch, mname):
    ref, _ = fsdp_run
    shape, names = PLACE_MESHES[mname]
    mesh = _NamedMesh(shape, names, (0,) * len(shape))
    shapes, specs = build_model(get_config(arch, smoke=True),
                                device="meta").abstract()
    flat_shapes = dict(pytree.flatten_with_keys(shapes))
    flat_specs = dict(_spec_leaves(specs))
    for k, (s, spec) in UNEVEN.items():
        flat_shapes[k] = torch.empty(s, device="meta")
        flat_specs[k] = spec
    dropped = 0
    for strategy in shd.STRATEGIES:
        rules = shd.MeshRules(mesh, strategy=strategy)
        fits = shd.resolve_tree(rules, flat_specs, flat_shapes)
        for k, logical in flat_specs.items():
            want = eval(str(ref[f"fit/{arch}/{mname}/{strategy}{k}"]))
            got = shd.fit_spec(rules, rules.spec(*logical),
                               flat_shapes[k].shape)
            assert got == want, (strategy, k, got, want)
            assert fits[k] == rules.named(want), (strategy, k)
            dropped += got != rules.spec(*logical)
    assert dropped, "no spec lost an axis: the uneven leaves should"


# ======================================================== the train step
def _leaf_check(tag: str, key: str):
    """How a state leaf is held, as ``(rule, bound)``: ``"close"`` at
    ``TRAIN_TOL``; ``"flips"``, at ``TRAIN_TOL`` but for at most one
    entry in a thousand of the whole leaf, each within ``bound``
    (``_assert_state_close``: the compressed step's quantizer flips, or
    an entry whose gradient is ~0, which Adam steps by up to lr either
    way); ``"scale"``, within ``bound`` times the leaf's largest entry.
    zamba2_2p7b's smoke model's float32 gradients are ill-conditioned in
    a few entries (``tests/test_torch_ssm.py`` says where): the
    reference's own sharded step, run again with XLA's CPU threading on
    instead of off, moved its moments by up to 0.103 of a leaf's largest
    entry, its params by up to 2.3e-3 with 1.07% of a leaf's entries
    outside ``TRAIN_TOL``, and its grad norm by 0.85%
    (``scripts/fsdp_spread.py``).  So its moments are held within
    ``ZAMBA_SPREAD`` of their leaf's scale, its params as the compressed
    step's but for ``ZAMBA_OUTLIERS`` of a leaf, and its grad norm at
    ``GRAD_NORM_RTOL``."""
    arch, compressed = CASES[tag][0], CASES[tag][-1]
    part = key.split("]")[0]
    moved = 2 * OPT["lr"] * STEPS
    if part == "['err'":
        return "flips", None
    if part == "['params'" and (compressed or arch == ZAMBA):
        return "flips", moved
    if arch == ZAMBA and "['step']" not in key:
        return "scale", ZAMBA_SPREAD
    return "close", None


def _hold(rule, bound, got, want, key, whole):
    """Assert one leaf (or block) by its rule; returns its entries
    outside ``TRAIN_TOL`` where the rule allows some (counted against
    the ``whole`` leaf by the caller)."""
    assert got.shape == want.shape, key
    if rule == "scale":
        atol = 1e-7 + bound * float(np.abs(whole).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=key)
        return 0
    if rule == "flips":
        flip = bound if bound is not None else 2.02 * max(
            np.abs(got).max(), np.abs(want).max())
        bad = ~np.isclose(got, want, **TRAIN_TOL)
        assert (np.abs(got - want)[bad] <= flip).all(), (key, flip)
        return int(bad.sum())
    np.testing.assert_allclose(got, want, **TRAIN_TOL, err_msg=key)
    return 0


def _allowed(tag: str, size: int) -> int:
    rate = ZAMBA_OUTLIERS if CASES[tag][0] == ZAMBA else 1e-3
    return max(1, int(size * rate))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_fsdp_state_equals_reference(fsdp_run, tag):
    """Params and moments (and the compressed step's error blocks),
    gathered on every rank, against the reference's after two steps."""
    ref, ranks = fsdp_run
    prefix = f"{tag}/state"
    keys = sorted(k for k in ref if k.startswith(prefix))
    for res in ranks:
        assert sorted(k for k in res if k.startswith(prefix)) == keys
        pod = int(res[f"{tag}/coord"][0])
        for k in keys:
            key = k[len(prefix):]
            want = ref[k][pod] if key.startswith("['err']") else ref[k]
            rule, bound = _leaf_check(tag, key)
            bad = _hold(rule, bound, res[k], want, k, want)
            assert bad <= _allowed(tag, want.size), (k, bad)
        assert int(res[f"{prefix}['opt']['step']"]) == STEPS


@pytest.mark.parametrize("tag", sorted(CASES))
def test_fsdp_local_blocks_equal_reference_shards(fsdp_run, tag):
    """Each rank holds only its block of every leaf: the reference's
    shard of its state at the rank's mesh coordinate."""
    ref, ranks = fsdp_run
    want = {k: v for k, v in ref.items() if k.startswith(f"{tag}/local")}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items()
                    if k.startswith(f"{tag}/local")})
    assert sorted(got) == sorted(want)
    smaller = 0
    for k, w in want.items():
        key = k[len(f"{tag}/local"):].rsplit("/", 1)[0]
        whole = ref[f"{tag}/state{key}"]
        smaller += got[k].size < whole.size
        rule, bound = _leaf_check(tag, key)
        bad = _hold(rule, bound, got[k], w, k, whole)
        assert bad <= _allowed(tag, whole.size), (k, bad)
    assert smaller, "no leaf is sharded"


@pytest.mark.parametrize("tag", sorted(CASES))
def test_fsdp_metrics_equal_reference_on_every_rank(fsdp_run, tag):
    ref, ranks = fsdp_run
    for i in range(STEPS):
        prefix = f"{tag}/m{i}/"
        names = sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
        assert "aux_loss" in names and "grad_norm" in names
        for res in ranks:
            assert sorted(k[len(prefix):] for k in res
                          if k.startswith(prefix)) == names
            for n in names:
                got, want = res[prefix + n], ref[prefix + n]
                assert got.tobytes() == ranks[0][prefix + n].tobytes(), n
                if n in ("step", "tokens"):
                    assert float(got) == float(want), n
                elif n == "grad_norm" and tag.startswith(ZAMBA):
                    np.testing.assert_allclose(
                        got, want, **dict(METRIC_TOL,
                                          rtol=GRAD_NORM_RTOL[ZAMBA]))
                else:
                    np.testing.assert_allclose(got, want, **METRIC_TOL,
                                               err_msg=n)
    if tag.startswith("deepseek"):
        assert float(ref[f"{tag}/m0/aux_loss"]) > 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_fsdp_collectives_move_the_blocks(fsdp_run, tag):
    """Every rank gathers weights and reduce-scatters gradients; the
    gathers (forward, recompute) carry more than the reduce-scatters."""
    _, ranks = fsdp_run
    for res in ranks:
        gathered = int(res[f"{tag}/bytes/all_gather"])
        scattered = int(res[f"{tag}/bytes/reduce_scatter"])
        assert scattered > 0 and gathered > scattered, (gathered, scattered)
    assert len({int(r[f"{tag}/bytes/all_gather"]) for r in ranks}) == 1


# ============================================ without ranks: the layout
def _fake_rules(shape, names, strategy, coord=None):
    return shd.MeshRules(_NamedMesh(shape, names, coord or (0,) * len(shape)),
                         strategy=strategy)


@pytest.mark.parametrize("strategy", ["megatron_sp", "tp_sp", "tp_dp"])
def test_fsdp_refuses_tensor_parallel_specs(strategy):
    """A ``tp`` entry on a model axis of 2 is realised by every family
    (the layer runs on the rank's slice: ``tests/test_torch_tp.py`` for
    the attention families, ``tests/test_torch_tp_ssm.py`` for the
    recurrent ones); a parameter cut on a logical axis that is neither
    storage nor ``tp``, or on two storage dimensions, still raises, and
    nothing falls back to replicated weights."""
    rules = _fake_rules((2, 2), MESH2, strategy)
    layout = shd.param_layout(rules, ("fsdp", "tp"), (8, 8))
    assert (layout.tp_dim, layout.tp_axes) == (1, ("model",))
    assert shd.block_shape(layout, rules.mesh) == (4, 4)
    for logical in (("dp", None), ("sp", None)):
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            shd.param_layout(rules, logical, (8, 8))
    with pytest.raises(NotImplementedError, match="two dimensions"):
        shd.param_layout(rules, ("fsdp", "fsdp_expert"), (8, 8))
    for arch in ("rwkv6_3b", "zamba2_2p7b"):
        model = build_model(get_config(arch, smoke=True), device="cpu")
        specs = pt_steps.param_specs(model)
        split = {n for n, p in model.named_parameters()
                 if shd.param_layout(rules, specs[n], p.shape).tp_axes}
        assert split and all(specs[n].count("tp") == 1 for n in split)
        assert not any(shd.is_sharded(p) for p in model.parameters())


def test_megatron_moe_body_still_refuses_autograd(monkeypatch):
    """The megatron MoE body trains (``tests/test_torch_tp.py`` holds
    deepseek_v2_lite_16b's step against the reference's), and the int8
    KV cache decodes over a model axis (``tests/test_torch_tp_ssm.py``
    holds yi_9b's on ranks); here grok1_314b's MoE blocks decode the
    int8 cache under ``megatron_sp`` rules whose axes span one rank
    exactly as without rules."""
    from repro_torch.models import transformer as pt_tr

    monkeypatch.setattr(pt_tr, "KV_CACHE_QUANT", True)
    cfg = get_config("grok1_314b", smoke=True)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    assert hasattr(model.blocks[0], "moe")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    prompt = torch.ones((2, 6), dtype=torch.int32)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": prompt}, max_seq=8)
        assert cache["k"].dtype == torch.int8
        want, _ = model.decode_step(tok, {k: v.clone()
                                          for k, v in cache.items()})
        rules = _fake_rules((1, 1), MESH2, "megatron_sp")
        with shd.use_rules(rules):
            got, _ = model.decode_step(tok, cache)
    assert torch.equal(got, want)
    assert not shd.in_gathered()


@pytest.mark.parametrize("coord", [0, 3])
def test_shard_train_state_cuts_blocks_and_keeps_decay(coord):
    """Blocks of the fitted spec at the rank's coordinate; ``abstract``
    still reports whole shapes; ``reference_decay`` reads each
    parameter's whole rank."""
    cfg = get_config("yi_9b", smoke=True)
    rules = _fake_rules((4,), ("data",), "fsdp", (coord,))
    model = build_model(cfg, device="cpu")
    state = pt_steps.init_train_state(model, torch.Generator().manual_seed(0))
    whole = {n: p.detach().clone() for n, p in state["params"].items()}
    decay = pt_steps.reference_decay(state["params"])
    shapes = model.abstract()[0]
    pt_steps.shard_train_state(model, state, rules)
    specs = pt_steps.param_specs(model)
    for n, p in state["params"].items():
        assert shd.is_sharded(p) and p.fsdp_shape == tuple(whole[n].shape)
        layout = shd.layout_of(p, rules)
        if layout.dim is None:
            assert torch.equal(p.detach(), whole[n]), n
        else:
            assert specs[n][layout.dim] == "fsdp", n
            assert torch.equal(p.detach(), whole[n].chunk(4, layout.dim)[coord])
        assert state["opt"]["m"][n].shape == p.shape
    assert model.blocks[0].attn["wq"].shape[0] == cfg.d_model // 4
    assert pt_steps.reference_decay(state["params"]) == decay
    # shard_tree cuts the reference's layout into the same blocks
    from repro_torch.models import transformer as pt_tr
    tree = pt_tr._reference_tree(whole)
    blocks = shd.shard_tree(tree, model.abstract()[1], rules)
    local = _block_tree(dict(state["params"]))
    for (k, got), (k2, want) in zip(pytree.flatten_with_keys(blocks),
                                    pytree.flatten_with_keys(local)):
        assert k == k2 and torch.equal(got, want), k
    assert [(k, tuple(x.shape)) for k, x in
            pytree.flatten_with_keys(model.abstract()[0])] == [
        (k, tuple(x.shape)) for k, x in pytree.flatten_with_keys(shapes)]


@pytest.mark.parametrize("micro", [1, 2])
def test_shard_batch_cuts_each_micro_batch(micro):
    """Each rank's rows of each of the reference's micro-batches; a
    global batch of one stays whole."""
    cfg = get_config("pixtral_12b", smoke=True)
    batch = pt_inputs.make_batch(cfg, 8, SEQ, device="cpu")
    n_dp = 2
    for d in range(n_dp):
        rules = _fake_rules((2, 1, 2), MESH3, "fsdp_dp", (d, 0, 1))
        local = pt_inputs.shard_batch(batch, rules, micro)
        assert sorted(local) == sorted(batch)
        for k, x in batch.items():
            parts = x.reshape(micro, 8 // micro, *x.shape[1:])
            want = parts.chunk(n_dp, dim=1)[d].reshape(-1, *x.shape[1:])
            assert torch.equal(local[k], want), k
    one = pt_inputs.make_batch(cfg, 1, SEQ, device="cpu")
    rules = _fake_rules((2, 2), MESH2, "fsdp", (1, 1))
    assert all(v is one[k] for k, v in
               pt_inputs.shard_batch(one, rules).items())


def test_gathered_is_a_no_op_on_unmarked_parameters():
    model = build_model(get_config("yi_9b", smoke=True), device="cpu")
    blk = model.blocks[0]
    before = dict(blk.named_parameters())
    with shd.use_rules(_fake_rules((2, 2), MESH2, "fsdp")):
        with shd.gathered(blk):
            assert not shd.in_gathered()
            assert all(p is before[n] for n, p in blk.named_parameters())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_sees_the_callers_rules(policy):
    """On the card the backward, and so a ``remat`` recompute, runs on
    the autograd engine's own thread; the recompute must still see the
    rules that were active in the forward (it gathers the block's
    weights under them).  Here the backward runs on a new thread."""
    import threading

    from repro_torch.models.transformer import _remat

    seen = []

    def block(x):
        seen.append(shd.active_rules())
        return torch.sin(x @ x.T).sum(0)

    rules = _fake_rules((2,), ("data",), "fsdp")
    x = torch.ones(3, 3, requires_grad=True)
    with shd.use_rules(rules):
        y = _remat(block, policy)(x).sum()
    grads = []
    worker = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join()
    assert len(grads) == 1 and len(seen) == 2
    assert all(r is rules for r in seen)
    assert shd.active_rules() is None
