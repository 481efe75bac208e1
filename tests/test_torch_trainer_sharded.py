"""The port's ``Trainer`` over sharded state (``Trainer(rules=...)``)
and its checkpoints, against the reference's ``Trainer`` running a
sharded ``jit`` step on a ``device_put`` state.

The reference runs in one subprocess on a 4-device CPU platform
(``tests/_multirank.py``): per case, its ``Trainer`` with a ``step_fn``
jitted with ``resolve_tree`` in_shardings under ``use_rules``, packed
ingest, ``STEPS`` steps from its seeded initial state, a checkpoint
every ``EVERY``.  It also saves that initial state as step 0, which the
port restores, so both start from the same weights.  The port runs as 4
spawned gloo ranks, each with its own in-process store and corpus built
from the same seed, and its ``Trainer(rules=...)`` over (data 2, model
2): the rank's block of every whole batch, the state cut by
``shard_train_state``, checkpoints gathered leaf by leaf and written by
rank 0 alone.  Checkpoints cross packages as the objects of one step.
All on core ``CORE`` at nice 10; the pytest worker joins no process
group and does not import the reference's dry run.

Cases (float32 smoke configs, lr 1e-3): yi_9b under ``fsdp``, rwkv6_3b
under ``tp_dp``, deepseek_v2_lite_16b under ``megatron_sp`` at capacity
n_routed / top_k (no token dropped, so its sharded and unsharded steps
are the same math).

Gates: the losses per step at ``METRIC_TOL``; the checkpoint at step
``EVERY``: manifest keys, shapes, dtypes and ``extra`` equal the
reference's, leaves at the FSDP gate (``TRAIN_TOL``, a parameter leaf
with at most one entry in a thousand outside, within 2 lr a step:
``_assert_close``); the port's checkpoint continued by the reference's
unsharded ``Trainer`` and the reference's continued by the port's
sharded one, each to the other's uninterrupted state at that gate; a
restart at step ``EVERY``
bit-equal on every rank's blocks to the uninterrupted run at
``STEPS``; only the writer's store holds checkpoint objects;
``train_state_to_reference`` refuses a sharded state."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from _multirank import _block_state, _np, _ranks, _reference

from repro_torch.configs import get_config
from test_torch_distributed import METRIC_TOL, TRAIN_TOL

CORE = -5
MESH = (2, 2)
NAMES = ("data", "model")
STEPS, EVERY = 4, 2
BATCH, SEQ, N_SEQS = 8, 64, 64
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# tag: (arch, strategy, capacity factor n_routed / top_k)
CASES = {
    "yi_9b/fsdp": ("yi_9b", "fsdp", False),
    "rwkv6_3b/tp_dp": ("rwkv6_3b", "tp_dp", False),
    "deepseek_v2_lite_16b/megatron_sp": ("deepseek_v2_lite_16b",
                                         "megatron_sp", True),
}


def _ckpt_prefix(step: int, tag: str = "train") -> str:
    return f"ckpt/{tag}/step-{step}/"


# ------------------------------------------------- the reference's run
PROG = """
import dataclasses, json
assert len(jax.devices()) == 4
from repro.launch.dryrun import resolve_tree   # after the backend
from repro.checkpoint import ckpt
from repro.configs import base
from repro.core import GlobalVOL, make_store
from repro.data.corpus import CorpusSpec, build_corpus
from repro.data.pipeline import ObjectDataLoader
from repro.distributed import sharding as shd
from repro.models import inputs
from repro.models.archs import build_model
from repro.train import optimizer as opt
from repro.train import steps
from repro.train.trainer import Trainer, TrainerConfig

def dump(store, prefix):
    return {n: np.frombuffer(store.get(n), np.uint8) for n in
            store.list_objects(prefix)}

for tag, (arch, strategy, nodrop) in CASES.items():
    cfg = base.get_config(arch, smoke=True)
    if nodrop:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    model = build_model(cfg, remat="full")
    store = make_store(4, replicas=2)
    vol = GlobalVOL(store)
    build_corpus(vol, CorpusSpec(n_seqs=N_SEQS, seq_len=SEQ,
                                 vocab_size=cfg.vocab_size, seed=1))
    rules = shd.MeshRules(mesh_of(MESH, NAMES), strategy=strategy)
    shapes, specs = steps.abstract_train_state(model, cfg.opt_dtype)
    batch_specs = inputs.train_input_specs(
        cfg, base.ShapeSpec("t", SEQ, BATCH, "train"))[1]
    in_sh = (resolve_tree(rules, specs, shapes),
             resolve_tree(rules, batch_specs))
    inner = jax.jit(steps.make_train_step(model, opt.OptConfig(**OPT)),
                    in_shardings=in_sh, out_shardings=(in_sh[0], None))

    def step_fn(s, b, inner=inner, rules=rules):
        with shd.use_rules(rules):
            return inner(s, b)

    init = jax.jit(lambda k: steps.init_train_state(model, k))(
        jax.random.PRNGKey(1))
    init_host = jax.device_get(init)       # the Trainer donates the state
    ckpt.save(store, init_host, 0, extra={"loader_step": 0})
    for n, b in dump(store, "ckpt/train/step-0/").items():
        OUT[f"{tag}/ckpt0/{n}"] = b
    loader = ObjectDataLoader(vol, "corpus", global_batch=BATCH, seed=3,
                              prefetch=0, packed=True)
    tr = Trainer(model, loader, store, opt=opt.OptConfig(**OPT),
                 cfg=TrainerConfig(total_steps=STEPS, ckpt_every=EVERY,
                                   log_every=100, packed_ingest=True),
                 step_fn=step_fn, log=lambda s: None)
    state = tr.run(jax.device_put(init, in_sh[0]), start_step=0)
    OUT[f"{tag}/losses"] = np.array([r["loss"] for r in tr.history])
    for n, b in dump(store, f"ckpt/train/step-{EVERY}/").items():
        OUT[f"{tag}/ckpt/{n}"] = b
    like = jax.tree.map(np.asarray, init_host)
    at_k, _ = ckpt.restore(store, like, step=EVERY)
    for k, v in keyed(at_k).items():
        OUT[f"{tag}/at_k{k}"] = host(v)
    for k, v in keyed(jax.device_get(state)).items():
        OUT[f"{tag}/final{k}"] = host(v)
"""


# ------------------------------------------------------ the port's ranks
def _cfg(arch: str, nodrop: bool):
    cfg = get_config(arch, smoke=True)
    if nodrop:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    return cfg


def _objects(z, prefix: str) -> dict[str, bytes]:
    return {k[len(prefix):]: z[k].tobytes() for k in z.files
            if k.startswith(prefix)}


def _job_trainer(rank: int, tmp) -> dict:
    import torch.distributed as dist

    from repro_torch import pytree
    from repro_torch.core import GlobalVOL, make_store
    from repro_torch.data.corpus import CorpusSpec, build_corpus
    from repro_torch.data.pipeline import ObjectDataLoader
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as pt_tr
    from repro_torch.models.archs import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    writer = dist.get_rank() == 0
    z = np.load(tmp / "ref.npz")
    out: dict = {}
    for tag, (arch, strategy, nodrop) in CASES.items():
        cfg = _cfg(arch, nodrop)
        rules = shd.MeshRules(make_smoke_mesh(MESH, NAMES, "cpu"),
                              strategy=strategy)

        def world(objects: dict):
            store = make_store(4, replicas=2)
            build_corpus(GlobalVOL(store), CorpusSpec(
                n_seqs=N_SEQS, seq_len=SEQ, vocab_size=cfg.vocab_size,
                seed=1))
            if writer:
                for name, blob in objects.items():
                    store.put(name, blob)
            return store

        def trainer(store):
            loader = ObjectDataLoader(GlobalVOL(store), "corpus",
                                      global_batch=BATCH, seed=3,
                                      prefetch=0, packed=True)
            return Trainer(build_model(cfg, remat="full", device="cpu"),
                           loader, store, opt=OptConfig(**OPT),
                           cfg=TrainerConfig(total_steps=STEPS,
                                             ckpt_every=EVERY,
                                             log_every=100,
                                             packed_ingest=True),
                           rules=rules, log=lambda s: None)

        def blocks(state) -> dict:
            return dict(pytree.flatten_with_keys(_block_state(state)))

        # from the reference's step 0 to STEPS, a checkpoint every EVERY
        store = world(_objects(z, f"{tag}/ckpt0/"))
        tr = trainer(store)
        state = tr.run()
        out[f"{tag}/losses"] = np.array([r["loss"] for r in tr.history])
        final = blocks(state)
        whole = pt_tr.sharded_state_to_reference(state, rules, writer)
        try:
            pt_tr.train_state_to_reference(state)
            out[f"{tag}/refused"] = np.array(False)
        except ValueError:
            out[f"{tag}/refused"] = np.array(True)
        for step in (EVERY, STEPS):
            out[f"{tag}/n_objects/{step}"] = np.array(
                len(store.list_objects(_ckpt_prefix(step))))
        if writer:
            for k, v in pytree.flatten_with_keys(whole):
                out[f"{tag}/final{k}"] = _np(v)
            for name in store.list_objects(_ckpt_prefix(EVERY)):
                out[f"{tag}/ckpt/{name}"] = np.frombuffer(store.get(name),
                                                          np.uint8)
            for name in store.list_objects(_ckpt_prefix(STEPS)):
                store.delete(name)
        # a restart at EVERY, on a fresh model and Trainer
        again = trainer(store)
        st2, start = again.init_or_restore()
        out[f"{tag}/restart_from"] = np.array(start)
        st2 = again.run(st2, start_step=start)
        out[f"{tag}/restart_losses"] = np.array(
            [r["loss"] for r in again.history])
        out[f"{tag}/restart_equal"] = np.array(all(
            torch.equal(v, final[k]) and v.dtype == final[k].dtype
            for k, v in blocks(st2).items()) and len(final) > 0)
        store.close()
        # the reference's checkpoint at EVERY, continued sharded
        store = world(_objects(z, f"{tag}/ckpt/"))
        cont = trainer(store)
        st3 = cont.run()
        whole = pt_tr.sharded_state_to_reference(st3, rules, writer)
        out[f"{tag}/cont_losses"] = np.array(
            [r["loss"] for r in cont.history])
        if writer:
            for k, v in pytree.flatten_with_keys(whole):
                out[f"{tag}/cont{k}"] = _np(v)
        store.close()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_sharded")
    ref = _reference(PROG, tmp, core=CORE, CASES=CASES, MESH=MESH,
                     NAMES=NAMES, STEPS=STEPS, EVERY=EVERY, BATCH=BATCH,
                     SEQ=SEQ, N_SEQS=N_SEQS, OPT=OPT)
    return ref, _ranks(_job_trainer, tmp, CORE)


def _leaves(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix) and k[len(prefix)] == "["}


def _manifest(res: dict, tag: str) -> dict:
    return json.loads(res[f"{tag}/ckpt/{_ckpt_prefix(EVERY)}.manifest"]
                      .tobytes())


# the FSDP gate (tests/test_torch_fsdp.py): a parameter leaf may have at
# most one entry in a thousand outside TRAIN_TOL, each within 2 lr a
# step (Adam moves an entry whose gradient is ~0 by up to lr either
# way); moments and the step are held at TRAIN_TOL
FLIP_RATE = 1e-3
FLIP_BOUND = 2 * OPT["lr"] * STEPS


def _assert_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not k.startswith("['params']"):
            np.testing.assert_allclose(g, w, **TRAIN_TOL, err_msg=k)
            continue
        bad = ~np.isclose(g, w, **TRAIN_TOL)
        assert bad.sum() <= max(1, int(w.size * FLIP_RATE)), (k, bad.sum())
        assert (np.abs(g - w)[bad] <= FLIP_BOUND).all(), k


# ============================================================== gates
@pytest.mark.parametrize("tag", sorted(CASES))
def test_losses_equal_reference_on_every_rank(trained, tag):
    ref, ranks = trained
    want = ref[f"{tag}/losses"]
    assert len(want) == STEPS and np.all(np.isfinite(want))
    for res in ranks:
        assert res[f"{tag}/losses"].tobytes() == \
            ranks[0][f"{tag}/losses"].tobytes()
        np.testing.assert_allclose(res[f"{tag}/losses"], want, **METRIC_TOL)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_checkpoint_equals_the_reference_checkpoint(trained, tag):
    """Manifest keys, shapes, dtypes and ``extra`` equal; the leaves at
    the FSDP gate."""
    ref, ranks = trained
    got, want = _manifest(ranks[0], tag), _manifest(ref, tag)
    assert {k: (m["dtype"], m["shape"]) for k, m in got["leaves"].items()} \
        == {k: (m["dtype"], m["shape"]) for k, m in want["leaves"].items()}
    assert got["extra"] == want["extra"] == {"loader_step": EVERY}
    assert got["step"] == EVERY
    from repro_torch import pytree
    from repro_torch.core import make_store
    store = make_store(4, replicas=2)
    prefix = f"{tag}/ckpt/"
    for k in ranks[0]:
        if k.startswith(prefix):
            store.put(k[len(prefix):], ranks[0][k].tobytes())
    manifest = json.loads(store.get(f"{_ckpt_prefix(EVERY)}.manifest"))
    leaves = {}
    for key, m in manifest["leaves"].items():
        raw = b"".join(store.get(n) for n, _, _ in m["objects"])
        leaves[key] = _np(pytree.from_bytes(bytearray(raw), m["dtype"],
                                            m["shape"], "cpu"))
    store.close()
    _assert_close(leaves, _leaves(ref, f"{tag}/at_k"))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_only_the_writer_stores_checkpoints(trained, tag):
    _, ranks = trained
    for step in (EVERY, STEPS):
        assert int(ranks[0][f"{tag}/n_objects/{step}"]) > 0
        for res in ranks[1:]:
            assert int(res[f"{tag}/n_objects/{step}"]) == 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_restart_is_bit_equal_on_every_rank(trained, tag):
    _, ranks = trained
    for res in ranks:
        assert int(res[f"{tag}/restart_from"]) == EVERY
        assert bool(res[f"{tag}/restart_equal"])
        assert res[f"{tag}/restart_losses"].tobytes() == \
            res[f"{tag}/losses"][EVERY:].tobytes()


@pytest.mark.parametrize("tag", sorted(CASES))
def test_train_state_to_reference_refuses_a_sharded_state(trained, tag):
    _, ranks = trained
    assert all(bool(res[f"{tag}/refused"]) for res in ranks)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_port_continues_the_reference_checkpoint_sharded(trained, tag):
    ref, ranks = trained
    np.testing.assert_allclose(ranks[0][f"{tag}/cont_losses"],
                               ref[f"{tag}/losses"][EVERY:], **METRIC_TOL)
    _assert_close(_leaves(ranks[0], f"{tag}/cont"),
                  _leaves(ref, f"{tag}/final"))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_reference_continues_the_port_checkpoint_unsharded(trained, tag):
    """The port's step-``EVERY`` checkpoint in a reference store, run to
    ``STEPS`` by the reference's unsharded ``Trainer`` (this process,
    one device): its state equals the port's uninterrupted one."""
    import jax

    from repro.checkpoint import ckpt as ref_ckpt
    from repro.core import GlobalVOL, make_store
    from repro.data.corpus import CorpusSpec, build_corpus
    from repro.data.pipeline import ObjectDataLoader
    from repro.models.archs import build_model
    from repro.train.optimizer import OptConfig
    from repro.train.trainer import Trainer, TrainerConfig

    _, ranks = trained
    arch, _, nodrop = CASES[tag]
    cfg = _ref_cfg(arch, nodrop)
    store = make_store(4, replicas=2)
    try:
        vol = GlobalVOL(store)
        build_corpus(vol, CorpusSpec(n_seqs=N_SEQS, seq_len=SEQ,
                                     vocab_size=cfg.vocab_size, seed=1))
        prefix = f"{tag}/ckpt/"
        for k in ranks[0]:
            if k.startswith(prefix):
                store.put(k[len(prefix):], ranks[0][k].tobytes())
        loader = ObjectDataLoader(vol, "corpus", global_batch=BATCH, seed=3,
                                  prefetch=0, packed=True)
        tr = Trainer(build_model(cfg, remat="full"), loader, store,
                     opt=OptConfig(**OPT),
                     cfg=TrainerConfig(total_steps=STEPS, ckpt_every=100,
                                       log_every=100, packed_ingest=True),
                     log=lambda s: None)
        state = tr.run()
        assert ref_ckpt.latest_step(store) == EVERY
        got = {jax.tree_util.keystr(k): _np(v) for k, v in
               jax.tree_util.tree_flatten_with_path(
                   jax.device_get(state))[0]}
    finally:
        store.close()
    np.testing.assert_allclose([r["loss"] for r in tr.history],
                               ranks[0][f"{tag}/losses"][EVERY:],
                               **METRIC_TOL)
    _assert_close(got, _leaves(ranks[0], f"{tag}/final"))


def _ref_cfg(arch: str, nodrop: bool):
    from repro.configs import base
    cfg = base.get_config(arch, smoke=True)
    if nodrop:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    return cfg
