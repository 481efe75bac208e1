"""The model axis (tensor parallelism) of the port's recurrent families,
and the int8 KV cache's decode under ``tp_sp``, against the reference's
sharded run on the same mesh.

The reference runs in one subprocess on a 4-device CPU platform (the
``tests/_multirank.py`` harness), each cell as ``launch/dryrun.py::
build_cell`` builds it: ``make_train_step``, ``model.prefill`` and
``model.decode_step`` under ``jax.jit(in_shardings=...)`` with its own
``resolve_tree`` and ``use_rules(rules)``; GSPMD inserts its
collectives.  The port runs the same cases as 4 spawned gloo ranks that
write theirs as explicit tensor-parallel layers (``models.ssm``: Mamba2
heads and RWKV6's value head dimension over "model"), each rank cutting
its blocks from the reference's seeded initial state.  The group runs
in one module-scoped fixture, on the fourth core from the end
(``CORE``; the model-axis file of the attention families has the third,
the FSDP file the second, the distributed file the last); this process
never joins a process group.

Train cases, 2 steps each at lr 1e-3 on float32 smoke configs under
``tp_dp`` on (data 2, model 2) with 2 micro-batches: rwkv6_3b (value
head dimension 16 split 8 / 8, d_ff 224 split) and zamba2_2p7b (8
Mamba2 heads and the shared block's 4 attention heads and d_ff split),
and zamba2_2p7b again with the reference's ``HEAD_TP = "head_dim"`` (its
flag flipped in its subprocess around the case, the port's when the
ranks build the model): the shared block's head dimension split 8 / 8.
Serve cases under ``tp_sp`` on (data 2, model 2): rwkv6_3b at batch 4,
zamba2_2p7b at batch 4 and 1 (its attention cache's sequence over every
axis), and yi_9b with the int8 KV cache (``KV_CACHE_QUANT``: the
reference's in its subprocess, the port's in its ranks) at batch 4 and
1, and at batch 4 under ``head_dim`` (q, k and v gathered on the head
dimension after the projection, so the cache quantizes whole vectors),
each a prefill of 14 tokens into a 32-position cache (the
reference's cache padded as its serve engine pads it) and 4 greedy
decode steps whose writes cross from one rank's block into the next.

Tolerances are ``tests/test_torch_tp.py``'s: params and moments at
``TRAIN_TOL``, gathered on every rank and as each rank's blocks against
the reference's shard at its coordinate; metrics at ``METRIC_TOL``,
``step`` and ``tokens`` exact and bit-equal across ranks; served logits
within ``LOGIT_TOL`` of the largest logit, greedy tokens exact, each
rank's cache block at ``TRAIN_TOL`` with the int8 ``k`` / ``v`` equal.
Two exceptions, each where the reference's own arithmetic decides.
zamba2_2p7b's smoke state is held as ``tests/test_torch_fsdp.py`` holds
it, within the reference's own spread (the comment above ``_hold``).  The int8
cache rounds values that the two runs computed in different orders:
where one lies on a half, the runs round it to neighbouring integers
(a quantizer flip, at most one entry in a thousand, each off by 1), and
a decode step's row whose cache holds a flipped entry is held at
``Q8_FLIP_TOL``.
Without ranks: the refusals that stay (a sequence-cut residual stream,
``megatron_sp``, and the compressed step over a recurrent model axis)."""

import re

import numpy as np
import pytest
import torch
from _multirank import (_block_state, _built, _coord, _NamedMesh, _np,
                        _ranks, _reference, _unflatten)

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import inputs as pt_inputs
from repro_torch.models.archs import build_model
from repro_torch.train import steps as pt_steps
from test_torch_distributed import METRIC_TOL, TRAIN_TOL
from test_torch_fsdp import ZAMBA_OUTLIERS, ZAMBA_SPREAD
from test_torch_ssm import GRAD_NORM_RTOL, ZAMBA

STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, MICRO = 4, 32, 2
PROMPT, S_MAX, DECODE = 14, 32, 4
LOGIT_TOL = 1e-4        # of the largest logit's magnitude
# the int8 cache's decode logits where a quantizer flip landed in the
# cache (``_q8_flips``): one cached value one quantum (1/127 of its
# token and head's largest) away moved yi_9b's smoke logits by 3.3e-4
# of the largest
Q8_FLIP_TOL = 1e-3
MESH2 = ("data", "model")
MESH = ((2, 2), MESH2)
# tag: arch, trained under tp_dp on (data 2, model 2) with MICRO
# micro-batches
CASES = {"rwkv6_3b/tp_dp": "rwkv6_3b", "zamba2_2p7b/tp_dp": "zamba2_2p7b",
         "zamba2_2p7b/tp_dp/head_dim": "zamba2_2p7b"}
# tag: (arch, batch, int8 KV cache), served under tp_sp on (data 2,
# model 2)
SERVE = {"rwkv6_3b/tp_sp/4": ("rwkv6_3b", 4, False),
         "zamba2_2p7b/tp_sp/4": ("zamba2_2p7b", 4, False),
         "zamba2_2p7b/tp_sp/1": ("zamba2_2p7b", 1, False),
         "yi_9b/q8/4": ("yi_9b", 4, True),
         "yi_9b/q8/1": ("yi_9b", 1, True),
         "yi_9b/q8/4/head_dim": ("yi_9b", 4, True)}
# the cases built with the reference's HEAD_TP = "head_dim" (its flag
# flipped in its subprocess around the case, the port's in the ranks):
# zamba's shared block and yi_9b's layers split on the head dimension
HEAD_DIM = tuple(t for t in (*CASES, *SERVE) if t.endswith("/head_dim"))
# cache leaves with a sequence axis (axis 2), which the engine pads
SEQ_LEAVES = ("k", "v", "k_scale", "v_scale")
ARCHS = sorted(set(CASES.values()) | {a for a, _, _ in SERVE.values()})
RECURRENT = ("rwkv6_3b", "zamba2_2p7b")
CORE = -4   # test_torch_tp.py has -3, test_torch_fsdp.py -2, _distributed -1


# ------------------------------------------------- the reference's run
PROG = """
assert len(jax.devices()) == 4
from repro.launch.dryrun import resolve_tree      # after the backend
assert jax.device_count() == 4
from repro.configs import base
from repro.distributed import sharding as shd
from repro.models import inputs
from repro.models import attention as attn
from repro.models import transformer as tfm
from repro.models.archs import build_model
from repro.train import optimizer as opt
from repro.train import steps


def head_tp(tag):
    # the reference reads the flag whenever it builds params or specs
    # (init, abstract), so it stays set for the whole case
    attn.HEAD_TP = "head_dim" if tag in HEAD_DIM else "padded"

inits = {}
def init_of(arch, model):
    if arch not in inits:
        inits[arch] = jax.jit(lambda k: steps.init_train_state(model, k))(
            jax.random.PRNGKey(1))
        for k, v in keyed(jax.device_get(inits[arch])).items():
            OUT[f"init/{arch}" + k] = host(v)
    return inits[arch]

mesh = mesh_of(*MESH)
rules = shd.MeshRules(mesh, strategy="tp_dp")
for tag, arch in CASES.items():
    head_tp(tag)
    cfg = base.get_config(arch, smoke=True)
    model = build_model(cfg, remat="full")
    state = init_of(arch, model)
    shapes, specs = steps.abstract_train_state(model, cfg.opt_dtype)
    step = steps.make_train_step(model, opt.OptConfig(**OPT),
                                 microbatches=MICRO)
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

rules = shd.MeshRules(mesh, strategy="tp_sp")
for tag, (arch, B, q8) in SERVE.items():
    head_tp(tag)
    tfm.KV_CACHE_QUANT = q8         # as dryrun.py's kvint8 variant sets it
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
        return jax.device_put({k: v if k not in SEQ_LEAVES else jnp.pad(
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
    tfm.KV_CACHE_QUANT = False
attn.HEAD_TP = "padded"
"""


# ------------------------------------------------------ the port's ranks
def _inits(z) -> dict:
    return {arch: _unflatten({k[len(f"init/{arch}"):]: z[k] for k in z.files
                              if k.startswith(f"init/{arch}[")})
            for arch in ARCHS}


def _head_tp(tag: str) -> str:
    """The case's ``HEAD_TP``."""
    return "head_dim" if tag in HEAD_DIM else "padded"


def _train(tag, arch, inits, mesh, out) -> None:
    from repro_torch.models import transformer as pt_tr
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch, smoke=True)
    rules = shd.MeshRules(mesh, strategy="tp_dp")
    model = _built(cfg, _head_tp(tag), remat="full")
    state = pt_tr.train_state_from_reference(model, inits[arch])
    state = pt_steps.shard_train_state(model, state, rules)
    step = pt_steps.make_train_step(model, OptConfig(**OPT),
                                    microbatches=MICRO)
    shd.reset_collective_bytes()
    with shd.use_rules(rules):
        for i in range(STEPS):
            whole = pt_inputs.make_batch(cfg, BATCH, SEQ, seed=20 + i,
                                         device="cpu")
            state, m = step(state, pt_inputs.shard_batch(whole, rules,
                                                         MICRO))
            for k, v in m.items():
                out[f"{tag}/m{i}/{k}"] = _np(v)
    for k, v in shd.COLLECTIVE_BYTES.items():
        out[f"{tag}/bytes/{k}"] = np.array(v)
    c = _coord(mesh.get_coordinate())
    local = _block_state(state)
    whole = pt_tr.sharded_state_to_reference(state, rules, writer=True)
    for k, v in pytree.flatten_with_keys(whole):
        out[f"{tag}/state{k}"] = _np(v)
    for k, v in pytree.flatten_with_keys(local):
        out[f"{tag}/local{k}/{c}"] = _np(v)


def _serve(tag, case, inits, ref, mesh, out) -> None:
    from repro_torch.models import transformer as pt_tr

    arch, B, q8 = case
    pt_tr.KV_CACHE_QUANT = q8
    try:
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
    finally:
        pt_tr.KV_CACHE_QUANT = False
    for k, v in shd.COLLECTIVE_BYTES.items():
        out[f"{tag}/bytes/{k}"] = np.array(v)
    c = _coord(mesh.get_coordinate())
    for k, v in pytree.flatten_with_keys(cache):
        out[f"{tag}/cache{k}/{c}"] = _np(v)


def _job_tp_ssm(rank: int, tmp) -> dict:
    from repro_torch.launch import mesh as pt_mesh

    with np.load(tmp / "ref.npz") as z:
        inits = _inits(z)
        ref = {k: z[k] for k in z.files if "/tok" in k}
    mesh = pt_mesh.make_smoke_mesh(*MESH, "cpu")
    out = {"coord": np.array(mesh.get_coordinate())}
    for tag, arch in CASES.items():
        _train(tag, arch, inits, mesh, out)
    for tag, case in SERVE.items():
        _serve(tag, case, inits, ref, mesh, out)
    return out


@pytest.fixture(scope="module")
def tp_ssm_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ssm")
    ref = _reference(PROG, tmp, core=CORE, CASES=CASES, STEPS=STEPS, OPT=OPT,
                     BATCH=BATCH, SEQ=SEQ, MICRO=MICRO, SERVE=SERVE,
                     MESH=MESH, PROMPT=PROMPT, S_MAX=S_MAX, DECODE=DECODE,
                     SEQ_LEAVES=SEQ_LEAVES, HEAD_DIM=HEAD_DIM)
    return ref, _ranks(_job_tp_ssm, tmp, CORE)


def _combines(arch: str) -> int:
    """How many layer outputs the model adds up over the model axis in
    one forward pass: rwkv6_3b's time and channel mix of each layer;
    zamba2_2p7b's Mamba2 layers and its shared block's attention and MLP
    at each use; yi_9b's attention and MLP of each layer."""
    cfg = get_config(arch, smoke=True)
    if arch == "zamba2_2p7b":
        inner = cfg.ssm.attn_every
        return cfg.n_layers // inner * (inner + 2)
    return 2 * cfg.n_layers


# ======================================================== the train step
# zamba2_2p7b's smoke model's float32 gradients are ill-conditioned in a
# few entries (tests/test_torch_ssm.py says where), so its state is held
# as tests/test_torch_fsdp.py holds it: moments within ZAMBA_SPREAD of
# their leaf's largest entry, params at TRAIN_TOL but for ZAMBA_OUTLIERS
# of a leaf (each within the two steps' largest update), the grad norm
# at GRAD_NORM_RTOL.  Under tp_dp the reference's own step, run with
# XLA's CPU threading on and off, moved its moments by 0.040 of a leaf's
# largest entry, its params by 1.5e-3 with 0.76% of a leaf's entries
# outside TRAIN_TOL, and its grad norm by 0.23% (scripts/fsdp_spread.py
# zamba2_2p7b tp_dp); the port's ranks stand 0.087, 1.7e-3, 1.07% and
# 0.57% from its single-threaded run.  With the reference's HEAD_TP =
# "head_dim" its own spread is wider, 0.1232 of a moment leaf's largest
# entry and 1.93% of a param leaf's entries (the shared attention's wv)
# outside TRAIN_TOL (scripts/fsdp_spread.py zamba2_2p7b tp_dp head_dim;
# 0.04045 and 0.76% with "padded" in the same run), so the head_dim case
# is held just above that (ZAMBA_HD).  rwkv6_3b's state is held at
# TRAIN_TOL throughout.
ZAMBA_HD = (0.13, 0.02)     # (moment spread, param outliers) under head_dim


def _zamba_limits(tag: str) -> tuple[float, float]:
    return ZAMBA_HD if tag in HEAD_DIM else (ZAMBA_SPREAD, ZAMBA_OUTLIERS)


def _hold(tag: str, key: str, got, want, whole) -> int:
    """One state leaf (or block) at ``TRAIN_TOL``, zamba2_2p7b's as the
    comment above says.  Returns its params' entries outside
    ``TRAIN_TOL`` (counted against the ``whole`` leaf's size by the
    caller)."""
    assert got.shape == want.shape, key
    if CASES[tag] != ZAMBA or "['step']" in key:
        np.testing.assert_allclose(got, want, **TRAIN_TOL, err_msg=key)
        return 0
    if key.startswith("['params']"):
        bad = ~np.isclose(got, want, **TRAIN_TOL)
        moved = 2 * OPT["lr"] * STEPS
        assert (np.abs(got - want)[bad] <= moved).all(), key
        return int(bad.sum())
    atol = 1e-7 + _zamba_limits(tag)[0] * float(np.abs(whole).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)
    return 0


def _allowed(tag: str, size: int) -> int:
    return int(size * _zamba_limits(tag)[1]) if CASES[tag] == ZAMBA else 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_ssm_state_equals_reference(tp_ssm_run, tag):
    """Params and moments, gathered on every rank, against the
    reference's after two steps."""
    ref, ranks = tp_ssm_run
    prefix = f"{tag}/state"
    keys = sorted(k for k in ref if k.startswith(prefix))
    for res in ranks:
        assert sorted(k for k in res if k.startswith(prefix)) == keys
        for k in keys:
            key = k[len(prefix):]
            bad = _hold(tag, key, res[k], ref[k], ref[k])
            assert bad <= _allowed(tag, ref[k].size), (k, bad)
        assert int(res[f"{prefix}['opt']['step']"]) == STEPS


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_ssm_local_blocks_equal_reference_shards(tp_ssm_run, tag):
    """Each rank holds only its block of every leaf, cut on a storage and
    a model dimension where the spec says so (Mamba2's heads, RWKV6's
    value head dimension and d_ff): the reference's shard of its state
    at the rank's mesh coordinate."""
    ref, ranks = tp_ssm_run
    want = {k: v for k, v in ref.items() if k.startswith(f"{tag}/local")}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items()
                    if k.startswith(f"{tag}/local")})
    assert sorted(got) == sorted(want)
    split = set()
    for k, w in want.items():
        key = k[len(f"{tag}/local"):].rsplit("/", 1)[0]
        whole = ref[f"{tag}/state{key}"]
        bad = _hold(tag, key, got[k], w, whole)
        assert bad <= _allowed(tag, whole.size), (k, bad)
        if got[k].size < whole.size:
            split.add(re.findall(r"\['(\w+)'\]", key)[-1])
    tp = {"wz", "wx", "conv_w", "norm_scale", "wo"} if CASES[tag] == ZAMBA \
        else {"wv", "wg", "ln_scale", "wo", "wk_c", "wv_c"}
    if tag in HEAD_DIM:         # the shared block's q, k and v weights too
        tp |= {"wq", "wk", "wv"}
    assert tp <= split, split


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_ssm_metrics_equal_reference_on_every_rank(tp_ssm_run, tag):
    ref, ranks = tp_ssm_run
    for i in range(STEPS):
        prefix = f"{tag}/m{i}/"
        names = sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
        assert "loss" in names and "grad_norm" in names
        for res in ranks:
            assert sorted(k[len(prefix):] for k in res
                          if k.startswith(prefix)) == names
            for n in names:
                got, want = res[prefix + n], ref[prefix + n]
                assert got.tobytes() == ranks[0][prefix + n].tobytes(), n
                if n in ("step", "tokens"):
                    assert float(got) == float(want), n
                elif n == "grad_norm" and CASES[tag] == ZAMBA:
                    np.testing.assert_allclose(
                        got, want, **dict(METRIC_TOL,
                                          rtol=GRAD_NORM_RTOL[ZAMBA]),
                        err_msg=n)
                else:
                    np.testing.assert_allclose(got, want, **METRIC_TOL,
                                               err_msg=n)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_ssm_train_moves_activations_over_the_model_axis(tp_ssm_run,
                                                           tag):
    """Every rank all-reduces at least each split layer's output of each
    forward pass (the rank's (B / 2, S, D) float32 block: 2 (n - 1) / n
    of it on the wire at n = 2), and gathers its storage blocks."""
    _, ranks = tp_ssm_run
    arch = CASES[tag]
    d = get_config(arch, smoke=True).d_model
    least = _combines(arch) * STEPS * BATCH // 2 * SEQ * d * 4
    for res in ranks:
        assert int(res[f"{tag}/bytes/all_reduce"]) >= least
        assert int(res[f"{tag}/bytes/all_gather"]) > 0
        assert int(res[f"{tag}/bytes/reduce_scatter"]) > 0


# ========================================================= serving
def _cache_blocks(ref, ranks, tag) -> tuple[dict, dict]:
    """(the reference's cache shards, the ranks' blocks), by key."""
    want = {k: v for k, v in ref.items() if k.startswith(f"{tag}/cache")}
    got = {}
    for res in ranks:
        got.update({k: v for k, v in res.items()
                    if k.startswith(f"{tag}/cache")})
    return want, got


def _q8_flips(ref, ranks, tag) -> set:
    """The batch rows whose int8 ``k`` / ``v`` blocks differ from the
    reference's; each entry that differs must be a quantizer flip (off
    by 1), at most one in a thousand of a block.  A block (L, B_loc, S,
    ...) holds the whole batch or, cut over "dp" (the mesh's "data"),
    the rows from its data coordinate on."""
    want, got = _cache_blocks(ref, ranks, tag)
    B = SERVE[tag][1]
    rows = set()
    for k, w in want.items():
        if w.dtype == np.int8:
            off = got[k].astype(np.int32) - w.astype(np.int32)
            assert np.abs(off).max() <= 1, k
            n = int(np.count_nonzero(off))
            assert n <= w.size // 1000, (k, n)
            b_loc = w.shape[1]
            assert B % b_loc == 0 and B // b_loc in (1, MESH[0][0]), k
            first = 0 if b_loc == B else int(k.rsplit("/", 1)[1].split(
                ",")[0]) * b_loc
            rows |= {first + int(r) for r in np.nonzero(off)[1]}
    return rows


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_tp_ssm_serve_logits_and_tokens_equal_reference(tp_ssm_run, tag):
    """Prefill's and every decode step's logits, whole (B, V) on every
    rank, within ``LOGIT_TOL`` of the largest logit (a decode step's row
    whose int8 cache holds a quantizer flip within ``Q8_FLIP_TOL``); the
    greedy tokens equal."""
    ref, ranks = tp_ssm_run
    flipped = _q8_flips(ref, ranks, tag) if SERVE[tag][2] else set()
    for res in ranks:
        for i in range(DECODE + 1):
            want = ref[f"{tag}/logits{i}"]
            got = res[f"{tag}/logits{i}"]
            assert got.shape == want.shape == (SERVE[tag][1],
                                               got.shape[1]), (tag, i)
            top = np.abs(want).max()
            for b in range(want.shape[0]):
                tol = Q8_FLIP_TOL if i and b in flipped else LOGIT_TOL
                np.testing.assert_allclose(
                    got[b], want[b], rtol=0, atol=tol * top,
                    err_msg=f"{tag} step {i} row {b}")
        for i in range(DECODE):
            assert np.array_equal(res[f"{tag}/tok{i}"], ref[f"{tag}/tok{i}"])


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_tp_ssm_serve_cache_blocks_equal_reference_shards(tp_ssm_run, tag):
    """Each rank's cache block (the recurrent states on their split
    dimension, batch over "dp", an attention cache's sequence over "sp"
    or every axis at batch 1) is the reference's shard at its coordinate
    after the decode steps; the int8 ``k`` / ``v`` are equal but for
    quantizer flips (``_q8_flips``)."""
    ref, ranks = tp_ssm_run
    want, got = _cache_blocks(ref, ranks, tag)
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if w.dtype != np.int8:
            np.testing.assert_allclose(got[k], w, **TRAIN_TOL, err_msg=k)
    _q8_flips(ref, ranks, tag)


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_tp_ssm_serve_moves_activations_over_the_model_axis(tp_ssm_run,
                                                           tag):
    """The prefill alone all-reduces each split layer's output over the
    model axis; the logits are all-gathered."""
    _, ranks = tp_ssm_run
    arch, B, _ = SERVE[tag]
    d = get_config(arch, smoke=True).d_model
    least = _combines(arch) * max(B // 2, 1) * PROMPT * d * 4
    for res in ranks:
        assert int(res[f"{tag}/bytes/all_reduce"]) >= least
        assert int(res[f"{tag}/bytes/all_gather"]) > 0


# ============================================ without ranks: refusals
def _fake_rules(shape, names, strategy, coord=None):
    return shd.MeshRules(_NamedMesh(shape, names, coord or (0,) * len(shape)),
                         strategy=strategy)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_models_refuse_a_sequence_cut_stream(arch):
    """The recurrent families split their layers over the model axis
    (every ``tp`` entry realised), but a scan runs
    the whole sequence: under ``megatron_sp`` (``act_seq`` over the
    model axis) ``loss``, ``prefill`` and ``decode_step`` raise, as the
    reference's ``pick_strategy`` never pairs them."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    batch = pt_inputs.make_batch(cfg, 2, 16, device="cpu")
    with shd.use_rules(_fake_rules((2, 2), MESH2, "megatron_sp", (1, 1))):
        with pytest.raises(NotImplementedError, match="whole sequence"):
            model.loss(batch)
        with pytest.raises(NotImplementedError, match="act_seq"):
            model.prefill({"tokens": batch["tokens"]})
        with pytest.raises(NotImplementedError, match="megatron_sp"):
            model.decode_step(batch["tokens"][:, :1],
                              model.init_cache(2, 16))
    with shd.use_rules(_fake_rules((2, 2), MESH2, "tp_sp")):
        assert model._seq() is None
    assert model.loss(batch)[0].isfinite()


@pytest.mark.parametrize("arch", RECURRENT)
def test_compressed_step_refuses_a_recurrent_model_axis(arch):
    """The compressed step runs the attention families' tensor-parallel
    layers (``tests/test_torch_tp.py``), not the recurrent families',
    which no reference run holds it to: a model axis of 2 raises; of 1,
    the step is built."""
    from repro_torch.distributed import compression as pt_comp
    from repro_torch.train.optimizer import OptConfig

    model = build_model(get_config(arch, smoke=True), device="cpu")
    names = ("pod", "data", "model")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        pt_comp.make_compressed_train_step(
            model, OptConfig(), _fake_rules((2, 1, 2), names, "megatron_sp"))
    assert callable(pt_comp.make_compressed_train_step(
        model, OptConfig(), _fake_rules((2, 2, 1), names, "megatron_sp")))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_split_leaves_must_agree(arch):
    """A layer reads its split from its leaves' block shapes; a leaf cut
    where its partner is whole raises instead of mixing slices."""
    from repro_torch.models import ssm

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, 4, cfg.d_model))
    with torch.no_grad():
        if arch == "rwkv6_3b":
            p = {k: v for k, v in model.blocks[0].tmix.items()}
            p["wv"] = p["wv"][..., :cfg.head_dim // 2]
            with pytest.raises(ValueError, match="alike"):
                ssm.rwkv6_tmix(cfg, p, x)
            c = {k: v for k, v in model.blocks[0].cmix.items()}
            c["wv_c"] = c["wv_c"][:cfg.d_ff // 2]
            with pytest.raises(ValueError, match="alike"):
                ssm.rwkv6_cmix(cfg, c, x)
        else:
            p = {k: v for k, v in model.mamba[0][0].mamba.items()}
            p["conv_w"] = p["conv_w"][:, :2]
            with pytest.raises(ValueError, match="alike"):
                ssm.mamba2_forward(cfg, p, x)
