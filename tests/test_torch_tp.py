"""The model axis (tensor parallelism) of the port's attention families:
the train step under ``megatron_sp`` and ``tp_dp``, the compressed step
under ``megatron_sp``, and ``prefill`` / ``decode_step`` under ``tp_sp``,
against the reference's sharded run on the same mesh.

The reference runs in one subprocess on a 4-device CPU platform (the
``tests/_multirank.py`` harness), each cell as ``launch/dryrun.py::
build_cell`` builds it: ``make_train_step`` (or
``make_compressed_train_step``), ``model.prefill`` and
``model.decode_step`` under ``jax.jit(in_shardings=...)`` with its own
``resolve_tree`` and ``use_rules(rules)``; GSPMD inserts its
collectives.  The port runs the same cases as 4 spawned gloo ranks that
write theirs as explicit tensor-parallel layers (``distributed.
sharding``'s autograd collectives), each rank cutting its blocks from
the reference's seeded initial state.  Each group runs in one
module-scoped fixture, on the third core from the end (``CORE``; the
FSDP file has the next, the distributed file the last); this process
never joins a process group.

Train cases, 2 steps each at lr 1e-3 on float32 smoke configs: yi_9b
(GQA heads, ``act_seq``, the vocabulary-parallel cross entropy),
deepseek_v2_lite_16b (MLA, the megatron MoE body under autograd,
capacity factor n_routed / top_k), both under ``megatron_sp`` on (data
2, model 2); pixtral_12b (16 patches + 16 tokens cut over 4) and
starcoder2_7b (6 heads: ``wq`` / ``wo`` whole while d_ff and the
vocabulary split) under ``megatron_sp`` on (data 1, model 4);
musicgen_large under ``tp_dp`` on (data 2, model 2) with 2
micro-batches; the compressed step of yi_9b under ``megatron_sp`` on
(pod 2, data 1, model 2); starcoder2_7b again under ``megatron_sp`` on
(data 1, model 4) with the reference's ``HEAD_TP = "head_dim"`` (its
flag flipped in its subprocess around the case, the port's when the
ranks build the model): ``wq``, ``wk``, ``wv`` and ``wo`` split on the
head dimension.  Serve cases under ``tp_sp`` on (data 2, model
2): yi_9b at batch 4 and 1 (the cache's sequence over every axis), yi_9b
at batch 4 under ``head_dim`` and
deepseek_v2_lite_16b at batch 4 (the latent cache), each a prefill of
14 tokens into a 32-position cache (``prefill(max_seq=...)``, the
reference's cache padded as its serve engine pads it) and 4 greedy
decode steps whose writes cross from one rank's block into the next.
Past the cache's end the reference's sharded decode drops the write
while its unsharded one clamps it to the last position; the port clamps
in both, so the cases stay inside the cache.

Tolerances: params and moments at ``TRAIN_TOL`` (atol 1e-4, rtol 1e-5),
gathered on every rank and as each rank's blocks against the reference's
shard at its coordinate; the compressed step's params and errors but for
quantizer flips (``_assert_state_close``); metrics at ``METRIC_TOL``,
``step`` and ``tokens`` exact and bit-equal across ranks; served logits
within ``LOGIT_TOL`` of the largest logit, greedy tokens exact, each
rank's cache block at ``TRAIN_TOL``.  Without ranks: every smoke arch's
parameter layout under ``megatron_sp``, ``tp_dp`` and ``tp_sp`` at (2,
2) and (1, 4), built under each ``HEAD_TP``, against the reference's
fitted specs (the recurrent
families' ``tp`` entries split too: ``tests/test_torch_tp_ssm.py``)."""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch
from _multirank import (_block_state, _built, _coord, _NamedMesh, _np,
                        _ranks, _reference, _spec_leaves, _unflatten)

from repro_torch import pytree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import inputs as pt_inputs
from repro_torch.train import steps as pt_steps
from test_torch_distributed import (METRIC_TOL, MOE_SMOKE, TRAIN_TOL,
                                    _assert_state_close)

STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 32
PROMPT, S_MAX, DECODE = 14, 32, 4
LOGIT_TOL = 1e-4        # of the largest logit's magnitude
MESH3 = ("pod", "data", "model")
MESH2 = ("data", "model")
MOE_CF = MOE_SMOKE.n_routed / MOE_SMOKE.top_k
# tag: (arch, strategy, mesh shape, mesh names, micro-batches, capacity
# factor, compressed)
CASES = {
    "yi_9b/megatron_sp": ("yi_9b", "megatron_sp", (2, 2), MESH2, 1, None,
                          False),
    "deepseek_v2_lite_16b/megatron_sp": (
        "deepseek_v2_lite_16b", "megatron_sp", (2, 2), MESH2, 1, MOE_CF,
        False),
    "pixtral_12b/megatron_sp": ("pixtral_12b", "megatron_sp", (1, 4), MESH2,
                                1, None, False),
    "starcoder2_7b/megatron_sp": ("starcoder2_7b", "megatron_sp", (1, 4),
                                  MESH2, 1, None, False),
    "musicgen_large/tp_dp": ("musicgen_large", "tp_dp", (2, 2), MESH2, 2,
                             None, False),
    "yi_9b/compressed": ("yi_9b", "megatron_sp", (2, 1, 2), MESH3, 1, None,
                         True),
    "starcoder2_7b/megatron_sp/head_dim": ("starcoder2_7b", "megatron_sp",
                                           (1, 4), MESH2, 1, None, False),
}
# tag: (arch, batch), served under tp_sp on (data 2, model 2)
SERVE = {"yi_9b/tp_sp/4": ("yi_9b", 4), "yi_9b/tp_sp/1": ("yi_9b", 1),
         "deepseek_v2_lite_16b/tp_sp/4": ("deepseek_v2_lite_16b", 4),
         "yi_9b/tp_sp/4/head_dim": ("yi_9b", 4)}
# the cases built with the reference's HEAD_TP = "head_dim" (its flag
# flipped in its subprocess around the case, the port's in the ranks)
HEAD_DIM = tuple(t for t in (*CASES, *SERVE) if t.endswith("/head_dim"))
# archs whose trained state is restored under the other HEAD_TP too
CROSS_LAYOUT = ("starcoder2_7b",)
SERVE_MESH = ((2, 2), MESH2)
ARCHS = sorted({c[0] for c in CASES.values()}
               | {a for a, _ in SERVE.values()})
TP_STRATEGIES = ("megatron_sp", "tp_dp", "tp_sp")
LAYOUT_MESHES = {"2x2": ((2, 2), MESH2), "1x4": ((1, 4), MESH2)}
HEAD_TPS = ("padded", "head_dim")
CORE = -3   # test_torch_fsdp.py has -2, test_torch_distributed.py -1


# ------------------------------------------------- the reference's run
PROG = """
import dataclasses
assert len(jax.devices()) == 4
from repro.launch.dryrun import resolve_tree      # after the backend
assert jax.device_count() == 4
from repro.configs import base
from repro.distributed import compression as comp
from repro.distributed import sharding as shd
from repro.models import inputs
from repro.models.archs import build_model
from repro.train import optimizer as opt
from repro.train import steps

from repro.models import attention as attn


def head_tp(tag):
    # the reference reads the flag whenever it builds params or specs
    # (init, abstract), so it stays set for the whole case
    attn.HEAD_TP = "head_dim" if tag in HEAD_DIM else "padded"


# every smoke arch's fitted specs under the tensor-parallel strategies,
# with HEAD_TP "padded" and "head_dim"
for layout in HEAD_TPS:
    attn.HEAD_TP = layout
    for arch in FIT_ARCHS:
        shapes, specs = build_model(
            base.get_config(arch, smoke=True)).abstract()
        for mname, (shape, names) in MESHES.items():
            mesh = mesh_of(shape, names)
            for strategy in TP_STRATEGIES:
                rules = shd.MeshRules(mesh, strategy=strategy)
                for k, sh in keyed(resolve_tree(rules, specs,
                                                shapes)).items():
                    OUT[f"fit/{layout}/{arch}/{mname}/{strategy}{k}"] = \
                        np.array(repr(tuple(sh.spec)))
attn.HEAD_TP = "padded"

inits = {}
def init_of(arch, model):
    if arch not in inits:
        inits[arch] = jax.jit(lambda k: steps.init_train_state(model, k))(
            jax.random.PRNGKey(1))
        for k, v in keyed(jax.device_get(inits[arch])).items():
            OUT[f"init/{arch}" + k] = host(v)
    return inits[arch]

for tag, (arch, strategy, shape, names, micro, cf, compressed) in CASES.items():
    head_tp(tag)
    cfg = base.get_config(arch, smoke=True)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    model = build_model(cfg, remat="full")
    state = init_of(arch, model)
    mesh = mesh_of(shape, names)
    rules = shd.MeshRules(mesh, strategy=strategy)
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

mesh = mesh_of(*SERVE_MESH)
rules = shd.MeshRules(mesh, strategy="tp_sp")
for tag, (arch, B) in SERVE.items():
    head_tp(tag)
    cfg = base.get_config(arch, smoke=True)
    model = build_model(cfg, remat="full")
    shapes, specs = model.abstract()
    p_sh = resolve_tree(rules, specs, shapes)
    shape = base.ShapeSpec("p", PROMPT, B, "prefill")
    b_specs = {k: v for k, v in inputs.train_input_specs(cfg, shape)[1].items()
               if k != "labels"}
    c_sh = resolve_tree(rules, model.abstract_cache(B, S_MAX)[1])
    t_sh = resolve_tree(rules, inputs.decode_input_specs(cfg, shape)[1])
    prefill = jax.jit(lambda p, b: model.prefill(p, b),
                      in_shardings=(p_sh, resolve_tree(rules, b_specs)))

    def grown(cache):     # the serve engine's _pad_cache, then placed
        return jax.device_put({k: v if v.ndim < 3 else jnp.pad(
            v, [(0, 0), (0, 0), (0, S_MAX - PROMPT)] + [(0, 0)] * (v.ndim - 3))
            for k, v in cache.items()}, c_sh)
    decode = jax.jit(model.decode_step, in_shardings=(p_sh, t_sh, c_sh),
                     out_shardings=(None, c_sh), donate_argnums=(2,))
    params = jax.device_put(init_of(arch, model)["params"], p_sh)
    batch = inputs.make_batch(cfg, B, PROMPT, seed=30)
    batch.pop("labels")
    with shd.use_rules(rules):
        logits, cache = prefill(params, batch)
        cache = grown(cache)
        OUT[f"{tag}/logits0"] = host(logits)
        for i in range(DECODE):
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            OUT[f"{tag}/tok{i}"] = host(tok)
            logits, cache = decode(params, tok, cache)
            OUT[f"{tag}/logits{i + 1}"] = host(logits)
    for k, arr in keyed(cache).items():
        for s in arr.addressable_shards:
            OUT[f"{tag}/cache{k}/{coord(mesh, s.device)}"] = host(s.data)
attn.HEAD_TP = "padded"
"""


# ------------------------------------------------------ the port's ranks
def _cfg(arch: str, cf):
    cfg = get_config(arch, smoke=True)
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _inits(z) -> dict:
    return {arch: _unflatten({k[len(f"init/{arch}"):]: z[k] for k in z.files
                              if k.startswith(f"init/{arch}[")})
            for arch in ARCHS}


def _head_tp(tag: str) -> str:
    """The case's ``HEAD_TP``."""
    return "head_dim" if tag in HEAD_DIM else "padded"


def _train(tag, case, inits, out) -> None:
    from repro_torch.distributed import compression as pt_comp
    from repro_torch.launch import mesh as pt_mesh
    from repro_torch.models import transformer as pt_tr
    from repro_torch.train.optimizer import OptConfig

    arch, strategy, shape, names, micro, cf, compressed = case
    cfg = _cfg(arch, cf)
    mesh = pt_mesh.make_smoke_mesh(shape, names, "cpu")
    rules = shd.MeshRules(mesh, strategy=strategy)
    model = _built(cfg, _head_tp(tag), remat="full")
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

    def whole_of(tree, r=rules):
        return shd.gather_tree(tree, specs["params"], shapes["params"], r)
    whole = pt_tr.sharded_state_to_reference(state, rules, writer=True)
    if compressed:
        err = pt_tr._reference_tree({n: e[0] for n, e in state["err"].items()})
        whole["err"] = whole_of(err, dataclasses.replace(
            rules, manual_axes=("pod",)))
        local["err"] = pytree.map_with_keys(lambda _, e: e[None], err)
    for k, v in pytree.flatten_with_keys(whole):
        out[f"{tag}/state{k}"] = _np(v)
    for k, v in pytree.flatten_with_keys(local):
        out[f"{tag}/local{k}/{c}"] = _np(v)
    out[f"{tag}/coord"] = np.array(mesh.get_coordinate())
    if arch in CROSS_LAYOUT and not compressed:
        out[f"{tag}/restored_other"] = np.array(
            _restored_under_the_other_layout(tag, cfg, whole, rules))


def _restored_under_the_other_layout(tag, cfg, whole, rules) -> bool:
    """The sharded state's checkpoint tree (its leaves whole), restored
    into a model built under the other ``HEAD_TP`` and written back:
    every leaf bit-equal."""
    from repro_torch.models import transformer as pt_tr

    other = "padded" if tag in HEAD_DIM else "head_dim"
    model = _built(cfg, other, remat="full")
    state = pt_steps.shard_train_state(model, pt_steps.init_train_state(
        model, torch.Generator().manual_seed(0)), rules)
    pt_tr.sharded_state_from_reference(model, state, whole, rules)
    back = pt_tr.sharded_state_to_reference(state, rules, writer=True)
    want = dict(pytree.flatten_with_keys(whole))
    got = dict(pytree.flatten_with_keys(back))
    return sorted(got) == sorted(want) and all(
        torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k]))
        for k in want)


def _serve(tag, arch, B, inits, ref, mesh, out) -> None:
    from repro_torch.models import transformer as pt_tr

    rules = shd.MeshRules(mesh, strategy="tp_sp")
    cfg = get_config(arch, smoke=True)
    model = _built(cfg, _head_tp(tag))
    pt_tr.params_from_reference(model, inits[arch]["params"])
    pt_steps.shard_params(model, rules)
    batch = pt_inputs.make_batch(cfg, B, PROMPT, seed=30, device="cpu")
    batch.pop("labels")
    shd.reset_collective_bytes()
    with torch.no_grad(), shd.use_rules(rules):
        logits, cache = model.prefill(batch, max_seq=S_MAX)
        out[f"{tag}/logits0"] = _np(logits)
        for i in range(DECODE):
            out[f"{tag}/tok{i}"] = _np(logits.argmax(-1)[:, None].int())
            tok = torch.from_numpy(ref[f"{tag}/tok{i}"])
            logits, cache = model.decode_step(tok, cache)
            out[f"{tag}/logits{i + 1}"] = _np(logits)
    for k, v in shd.COLLECTIVE_BYTES.items():
        out[f"{tag}/bytes/{k}"] = np.array(v)
    c = _coord(mesh.get_coordinate())
    for k, v in pytree.flatten_with_keys(cache):
        out[f"{tag}/cache{k}/{c}"] = _np(v)


def _job_tp(rank: int, tmp) -> dict:
    from repro_torch.launch import mesh as pt_mesh

    with np.load(tmp / "ref.npz") as z:
        inits = _inits(z)
        ref = {k: z[k] for k in z.files if "/tok" in k}
    out = {}
    for tag, case in CASES.items():
        _train(tag, case, inits, out)
    mesh = pt_mesh.make_smoke_mesh(*SERVE_MESH, "cpu")
    for tag, (arch, B) in SERVE.items():
        _serve(tag, arch, B, inits, ref, mesh, out)
    return out


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ref = _reference(PROG, tmp, core=CORE, CASES=CASES, STEPS=STEPS, OPT=OPT,
                     BATCH=BATCH, SEQ=SEQ, SERVE=SERVE, SERVE_MESH=SERVE_MESH,
                     PROMPT=PROMPT, S_MAX=S_MAX, DECODE=DECODE,
                     FIT_ARCHS=ARCH_IDS, HEAD_DIM=HEAD_DIM,
                     MESHES=LAYOUT_MESHES, TP_STRATEGIES=TP_STRATEGIES,
                     HEAD_TPS=HEAD_TPS)
    return ref, _ranks(_job_tp, tmp, CORE)


# ======================================================== the train step
def _hold(tag: str, key: str, got, want, whole) -> None:
    """One state leaf (or block): at ``TRAIN_TOL``, the compressed
    step's params and errors but for quantizer flips."""
    assert got.shape == want.shape, key
    part = key.split("]")[0]
    if CASES[tag][-1] and part == "['err'":
        flip = 2.02 * max(np.abs(got).max(), np.abs(want).max())
        _assert_state_close(got, want, key, flip)
    elif CASES[tag][-1] and part == "['params'":
        _assert_state_close(got, want, key, 2 * OPT["lr"] * STEPS)
    else:
        np.testing.assert_allclose(got, want, **TRAIN_TOL, err_msg=key)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_state_equals_reference(tp_run, tag):
    """Params and moments (and the compressed step's error blocks),
    gathered on every rank, against the reference's after two steps."""
    ref, ranks = tp_run
    prefix = f"{tag}/state"
    keys = sorted(k for k in ref if k.startswith(prefix))
    for res in ranks:
        assert sorted(k for k in res if k.startswith(prefix)) == keys
        pod = int(res[f"{tag}/coord"][0])
        for k in keys:
            key = k[len(prefix):]
            want = ref[k][pod] if key.startswith("['err']") else ref[k]
            _hold(tag, key, res[k], want, want)
        assert int(res[f"{prefix}['opt']['step']"]) == STEPS


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_local_blocks_equal_reference_shards(tp_run, tag):
    """Each rank holds only its block of every leaf, cut on a storage and
    a model dimension where the spec says so: the reference's shard of
    its state at the rank's mesh coordinate."""
    ref, ranks = tp_run
    want = {k: v for k, v in ref.items() if k.startswith(f"{tag}/local")}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items()
                    if k.startswith(f"{tag}/local")})
    assert sorted(got) == sorted(want)
    on_model = set()
    for k, w in want.items():
        key = k[len(f"{tag}/local"):].rsplit("/", 1)[0]
        whole = ref[f"{tag}/state{key}"]
        if got[k].size < whole.size:
            on_model.add(re.findall(r"\['(\w+)'\]", key)[-1])
        _hold(tag, key, got[k], w, whole)
    assert on_model, "no leaf is sharded"
    if tag in HEAD_DIM:     # the KV weights split too: no repeated product
        assert {"wq", "wk", "wv", "wo"} <= on_model, on_model


@pytest.mark.parametrize("tag", sorted(t for t in CASES
                                        if CASES[t][0] in CROSS_LAYOUT))
def test_tp_state_restores_under_the_other_head_tp(tp_run, tag):
    """A checkpoint written from a sharded state under one ``HEAD_TP``
    (its leaves whole, the reference's layout) restores into a model
    sharded under the other and is written back bit-equal, on every
    rank: the switch changes where a leaf is cut, never what is
    stored."""
    _, ranks = tp_run
    assert all(bool(r[f"{tag}/restored_other"]) for r in ranks)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_metrics_equal_reference_on_every_rank(tp_run, tag):
    ref, ranks = tp_run
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
                else:
                    np.testing.assert_allclose(got, want, **METRIC_TOL,
                                               err_msg=n)
    if tag.startswith("deepseek"):
        assert float(ref[f"{tag}/m0/aux_loss"]) > 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_collectives_move_activations(tp_run, tag):
    """Every rank gathers, reduce-scatters and all-reduces; under
    ``megatron_sp`` the sequence gathers and scatters (activations) come
    on top of the weights' storage gathers, so the ranks along the model
    axis move as much as each other."""
    _, ranks = tp_run
    for res in ranks:
        moved = {k: int(res[f"{tag}/bytes/{k}"])
                 for k in ("all_gather", "reduce_scatter", "all_reduce")}
        assert all(moved.values()), moved
    assert len({int(r[f"{tag}/bytes/all_gather"]) for r in ranks}) == 1


# ========================================================= serving
@pytest.mark.parametrize("tag", sorted(SERVE))
def test_tp_serve_logits_and_tokens_equal_reference(tp_run, tag):
    """Prefill's and every decode step's logits, whole (B, V) on every
    rank, within ``LOGIT_TOL`` of the largest logit; the greedy tokens
    equal."""
    ref, ranks = tp_run
    for res in ranks:
        for i in range(DECODE + 1):
            want = ref[f"{tag}/logits{i}"]
            got = res[f"{tag}/logits{i}"]
            assert got.shape == want.shape == (SERVE[tag][1],
                                               got.shape[1]), (tag, i)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max(),
                err_msg=f"{tag} step {i}")
        for i in range(DECODE):
            assert np.array_equal(res[f"{tag}/tok{i}"], ref[f"{tag}/tok{i}"])


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_tp_serve_cache_blocks_equal_reference_shards(tp_run, tag):
    """Each rank's cache block, cut on the batch over "dp" and on the
    sequence over "sp" (every axis at batch 1), is the reference's shard
    at its coordinate after the decode steps: each write landed on the
    rank that owns its position, and the positions past the prompt that
    no step reached are zeros."""
    ref, ranks = tp_run
    want = {k: v for k, v in ref.items() if k.startswith(f"{tag}/cache")}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items()
                    if k.startswith(f"{tag}/cache")})
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, **TRAIN_TOL, err_msg=k)
    for res in ranks:
        moved = int(res[f"{tag}/bytes/all_reduce"])
        assert moved > 0 and int(res[f"{tag}/bytes/all_gather"]) > 0


# ============================================ without ranks: the layout
def _fake_rules(shape, names, strategy, coord=None):
    return shd.MeshRules(_NamedMesh(shape, names, coord or (0,) * len(shape)),
                         strategy=strategy)


@pytest.mark.parametrize("strategy", TP_STRATEGIES)
@pytest.mark.parametrize("mname", sorted(LAYOUT_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("head_tp", HEAD_TPS)
def test_tp_param_layout_equals_reference(tp_run, head_tp, arch, mname,
                                          strategy):
    """Every parameter's layout (storage and ``tp`` dimensions, block
    shape) follows the reference's fitted spec, the model built under
    each ``HEAD_TP``, and every arch, the recurrent families included,
    splits some leaf over the model axis (their refusal of
    ``megatron_sp``'s sequence cut is the models':
    ``tests/test_torch_tp_ssm.py``)."""
    ref, _ = tp_run
    shape, names = LAYOUT_MESHES[mname]
    rules = _fake_rules(shape, names, strategy)
    model = _built(get_config(arch, smoke=True), head_tp, device="meta")
    shapes, specs = model.abstract()
    flat_shapes = dict(pytree.flatten_with_keys(shapes))
    split = 0
    for k, logical in _spec_leaves(specs):
        want = eval(str(ref[f"fit/{head_tp}/{arch}/{mname}/{strategy}{k}"]))
        assert shd.fit_spec(rules, rules.spec(*logical),
                            flat_shapes[k].shape) == want, k
        whole = tuple(flat_shapes[k].shape)
        tp_dims = [d for d, (n, e) in enumerate(zip(logical, want))
                   if n == "tp" and e is not None]
        layout = shd.param_layout(rules, logical, whole)
        assert layout.tp_dim == (tp_dims[0] if tp_dims else None), k
        sizes = dict(zip(names, shape))
        cut = tuple(s // math.prod(sizes[a] for a in (
            e if isinstance(e, tuple) else (e,) if e else ()))
            for s, e in zip(whole, want))
        assert shd.block_shape(layout, rules.mesh) == tuple(cut), k
        split += layout.tp_dim is not None
    assert split


def test_tp_local_kv_pairs_each_head_with_its_own():
    """Each rank's query heads attend with the KV heads they read (head h
    reads h // G), whatever the split: a block of groups, one KV head
    shared by every local head, or neither."""
    from repro_torch.models.attention import _local_kv

    k = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    v = -k
    for H, n in ((8, 4), (8, 2), (8, 1), (12, 3), (8, 8)):
        G = H // 4
        for head0 in range(0, H, n):
            k_h, v_h = _local_kv(k, v, head0, n, G)
            g = n // k_h.shape[2]
            idx = torch.arange(head0, head0 + n) // G
            assert torch.equal(k_h.repeat_interleave(g, 2),
                               k.index_select(2, idx)), (H, n, head0)
            assert torch.equal(v_h.repeat_interleave(g, 2),
                               v.index_select(2, idx))


@pytest.mark.parametrize("n", [2, 4])
def test_tp_sequence_cut_refuses_what_the_model_axis_does_not_divide(n):
    group = shd.AxisGroup(None, n, n - 1)
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    assert torch.equal(shd.seq_slice(x, 1, group), x.chunk(n, 1)[n - 1])
    assert shd.seq_slice(x, 1, None) is x
    with pytest.raises(ValueError, match="does not divide"):
        shd.seq_slice(x[:, :7], 1, group)


def test_tp_groups_follow_the_rules():
    """``logical_group`` drops axes of size 1 and indexes the rank row-
    major; ``tp_group`` is None for a whole layer and refuses a slice
    the rules do not cut."""
    rules = _fake_rules((2, 2), MESH2, "megatron_sp", (1, 1))
    assert shd.logical_group(rules, "tp") == shd.AxisGroup("model", 2, 1)
    assert shd.logical_group(rules, "act_seq").index == 1
    assert shd.logical_group(_fake_rules((1, 4), MESH2, "tp_dp", (0, 2)),
                             "dp") is None
    assert shd.logical_group(None, "tp") is None
    with shd.use_rules(rules):
        assert shd.tp_group(8, 8) is None
        assert shd.tp_group(8, 4) == shd.AxisGroup("model", 2, 1)
        with pytest.raises(ValueError, match="slice"):
            shd.tp_group(8, 2)
    with shd.use_rules(_fake_rules((2, 2), MESH2, "fsdp")):
        with pytest.raises(ValueError, match="slice"):
            shd.tp_group(8, 4)
