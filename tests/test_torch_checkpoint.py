"""Train state and KV-cache pages as store objects, on ``repro`` and on
``repro_torch``: leaf keys equal to ``jax.tree_util.keystr``, manifests
and stored blobs byte-equal between the packages, and checkpoints and
page sets written by either restored bit-exactly by the other, with
bfloat16, float32 and int32 leaves.  JAX is imported inside the tests
that use it."""

import collections
import json

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.checkpoint import ckpt
from repro_torch.core import PartitionPolicy, make_store
from repro_torch.core.store import PartialWriteError
from repro_torch.serve import kvcache

Pair = collections.namedtuple("Pair", "first second")


def _bf16_bits(rng, shape) -> np.ndarray:
    """bfloat16 values as their uint16 bit patterns (normals, truncated:
    no NaN), so both packages get bit-identical leaves."""
    x = rng.normal(size=shape).astype(np.float32)
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def _leaves(seed=0) -> dict[str, tuple[str, np.ndarray]]:
    """name -> (dtype, values): the raw material of one state tree."""
    rng = np.random.default_rng(seed)
    return {
        "w": ("bfloat16", _bf16_bits(rng, (64, 48))),
        "b": ("bfloat16", _bf16_bits(rng, (48,))),
        "m": ("float32", rng.normal(size=(256, 48)).astype(np.float32)),
        "v": ("float32", rng.random((3, 5, 7)).astype(np.float32)),
        "step": ("int32", np.asarray(7, np.int32)),
        "ids": ("int32", rng.integers(-1000, 1000, 333).astype(np.int32)),
    }


def _tree(make):
    """The state tree, each leaf built by ``make(dtype, values)``."""
    L = {k: make(*v) for k, v in _leaves().items()}
    return {"params": {"w": L["w"], "b": L["b"]},
            "opt": {"m": L["m"], "v": L["v"], "step": L["step"]},
            "data": [L["ids"]]}


def _torch_leaf(dtype, values):
    if dtype == "bfloat16":
        return torch.from_numpy(values.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(values.copy())


def _jax_leaf(dtype, values):
    import jax.numpy as jnp
    import ml_dtypes
    if dtype == "bfloat16":
        return jnp.asarray(values.view(ml_dtypes.bfloat16))
    return jnp.asarray(values)


def _raw(x) -> bytes:
    """A leaf's bytes, from either package's tensor or array."""
    if isinstance(x, torch.Tensor):
        return pytree.to_bytes(x)
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _objects(store) -> dict[str, bytes]:
    return {n: store.get(n) for n in store.list_objects()}


def _ref_store(*a, **kw):
    from repro.core import make_store as ref_make_store
    return ref_make_store(*a, **kw)


# ------------------------------------------------------------------ keys
TREES = {
    "nested": lambda: {"params": {"w": 1, "b": [2, (3, 4)]}, "step": 5},
    "unsorted": lambda: {"z": 1, "a": {"y": 2, "B": 3}, "m": [4]},
    "list_root": lambda: [{"k": 1, "v": 2}, 3, (4,)],
    "none_holes": lambda: {"a": None, "b": [None, 1], "c": (2, None)},
    "int_keys": lambda: {0: "x", 1: {2: "y"}},
    "namedtuple": lambda: {"p": Pair(1, [2, 3])},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_keys_equal_jax_keystr(name):
    import jax
    tree = TREES[name]()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]
    assert pytree.flatten_with_keys(tree) == want


@pytest.mark.parametrize("name", sorted(TREES))
def test_map_with_keys_keeps_the_structure(name):
    import jax
    tree = TREES[name]()
    got = pytree.map_with_keys(lambda k, v: (k, v), tree)
    want = jax.tree_util.tree_map_with_path(
        lambda p, v: (jax.tree_util.keystr(p), v), tree)
    assert got == want


@pytest.mark.parametrize("dtype", sorted(pytree.DTYPES))
def test_leaf_bytes_round_trip_every_dtype(dtype):
    rng = np.random.default_rng(1)
    top = 2 if dtype == "bool" else 256
    raw = rng.integers(0, top, 4 * 3 * 16, dtype=np.uint8).tobytes()
    t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        pytree.DTYPES[dtype])
    t = t.reshape(4, 3, -1)
    assert pytree.to_bytes(t) == raw
    back = pytree.from_bytes(raw, dtype, t.shape)
    assert back.dtype == pytree.DTYPES[dtype] and pytree.to_bytes(back) == raw
    if dtype != "bfloat16":
        np.testing.assert_array_equal(
            np.frombuffer(raw, dtype).reshape(t.shape).view(np.uint8),
            back.numpy().view(np.uint8))
    # non-contiguous views serialize in C order; empty and 0-d leaves
    assert pytree.to_bytes(t.transpose(0, 1)) == \
        pytree.to_bytes(t.transpose(0, 1).contiguous())
    assert pytree.from_bytes(b"", dtype, (0, 3)).shape == (0, 3)
    assert pytree.from_bytes(raw[:t.element_size()], dtype, ()).shape == ()


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("io", ["buffered", "windowed"])
def test_manifests_and_blobs_byte_equal(io):
    """The same state saved by both packages: the same object names,
    the same manifest bytes, the same blob bytes — through the buffered
    path, and through one windowed streaming put_batch."""
    from repro.checkpoint import ckpt as ref_ckpt
    kw = {"client_bw": 50e9} if io == "windowed" else {}
    policy = PartitionPolicy(target_object_bytes=4 << 10,
                             max_object_bytes=32 << 10)
    from repro.core import PartitionPolicy as RefPolicy
    ref_policy = RefPolicy(target_object_bytes=4 << 10,
                           max_object_bytes=32 << 10)
    rs, ps = _ref_store(4, replicas=2, **kw), make_store(4, replicas=2, **kw)
    ref_m = ref_ckpt.save(rs, _tree(_jax_leaf), 100, policy=ref_policy,
                          extra={"lr": 0.1})
    pt_m = ckpt.save(ps, _tree(_torch_leaf), 100, policy=policy,
                     extra={"lr": 0.1})
    assert json.dumps(pt_m) == json.dumps(ref_m)
    assert sorted(pt_m["leaves"]) == [
        "['data'][0]", "['opt']['m']", "['opt']['step']", "['opt']['v']",
        "['params']['b']", "['params']['w']"]
    assert pt_m["leaves"]["['params']['w']"]["dtype"] == "bfloat16"
    ref_objs, pt_objs = _objects(rs), _objects(ps)
    assert sorted(pt_objs) == sorted(ref_objs)
    assert len(pt_objs) > 7                  # leaves span several objects
    for name in ref_objs:
        assert pt_objs[name] == ref_objs[name], name


def test_checkpoints_restore_across_packages():
    from repro.checkpoint import ckpt as ref_ckpt
    rs, ps = _ref_store(4, replicas=2), make_store(4, replicas=2)
    ref_ckpt.save(rs, _tree(_jax_leaf), 10)
    ckpt.save(ps, _tree(_torch_leaf), 20)
    # the reference's checkpoint restored by the port, and back
    like = _tree(_torch_leaf)
    got, manifest = ckpt.restore(make_store_from(rs), like)
    assert manifest["step"] == 10
    want = _tree(_torch_leaf)
    for (k, a), (k2, b) in zip(pytree.flatten_with_keys(got),
                               pytree.flatten_with_keys(want)):
        assert k == k2 and isinstance(a, torch.Tensor)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _raw(a) == _raw(b), k
    ref_like = _tree(lambda d, v: np.asarray(_jax_leaf(d, v)))
    back, manifest = ref_ckpt.restore(ref_store_from(ps), ref_like)
    assert manifest["step"] == 20
    for (k, a), (_, b) in zip(pytree.flatten_with_keys(back),
                              pytree.flatten_with_keys(want)):
        assert str(a.dtype) == pytree.DTYPE_NAMES[b.dtype], k
        assert _raw(a) == _raw(b), k


def make_store_from(ref_store):
    """A port store holding a reference store's objects and xattrs."""
    from repro_torch.core.store import ObjectStore
    return ObjectStore.from_state(_export(ref_store))


def ref_store_from(pt_store):
    """A reference store holding a port store's objects (same map)."""
    store = _ref_store(len(pt_store.osds), replicas=pt_store.cluster.replicas)
    for osd_id, osd in pt_store.osds.items():
        with osd.lock:
            for name, blob in osd.data.items():
                store.osds[osd_id].put(name, blob, dict(osd.xattrs[name]))
    return store


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


def test_roundtrip_latest_step_tags_and_atomicity():
    store = make_store(4, replicas=2)
    state = _tree(_torch_leaf)
    ckpt.save(store, state, 10)
    ckpt.save(store, state, 30)
    ckpt.save(store, state, 20, tag="eval")
    assert ckpt.latest_step(store) == 30
    assert ckpt.latest_step(store, tag="eval") == 20
    # a crashed save of step 40: leaves written, no manifest
    for i, (key, arr) in enumerate(sorted(ckpt._flatten(state).items())):
        store.put(f"ckpt/train/step-40/leaf-{i:05d}/obj.000000",
                  pytree.to_bytes(arr))
    assert ckpt.latest_step(store) == 30
    got, manifest = ckpt.restore(store, state)
    assert manifest["step"] == 30
    for (_, a), (_, b) in zip(pytree.flatten_with_keys(got),
                              pytree.flatten_with_keys(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_survives_osd_failure_and_rejects_bad_leaves():
    store = make_store(5, replicas=3)
    state = _tree(_torch_leaf)
    ckpt.save(store, state, 5)
    store.fail_osd(store.cluster.osds[0])
    store.fail_osd(store.cluster.osds[1])
    got, _ = ckpt.restore(store, state)
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    with pytest.raises(ValueError):
        ckpt.restore(store, {**state, "data": [torch.zeros(2)]})
    with pytest.raises(KeyError):
        ckpt.restore(store, {**state, "extra": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(store, state, tag="nope")


def test_manager_snapshots_before_returning_and_retires():
    store = make_store(3, replicas=2)
    mgr = ckpt.CheckpointManager(store, every_steps=1, keep=2)
    state = _tree(_torch_leaf)
    saved = {}
    for step in (1, 2, 3, 4):
        assert mgr.maybe_save(state, step)
        saved[step] = state["opt"]["m"].clone()
        state["opt"]["m"].add_(1.0)    # the next "train step", at once
    mgr.wait()
    steps = sorted(int(n.split("step-")[1].split("/")[0])
                   for n in store.list_objects("ckpt/")
                   if n.endswith(".manifest"))
    assert steps == [3, 4]
    for step in (3, 4):
        got, _ = ckpt.restore(store, state, step=step)
        assert torch.equal(got["opt"]["m"], saved[step])
    assert not any(f"step-{s}/" in n for n in store.list_objects()
                   for s in (1, 2))


def test_partial_save_reconciles_to_bit_exact_checkpoint():
    """As the self-heal suite: a save killed mid-stream, reconciled from
    the error's persisted listing, then retried — on both packages,
    with the same persisted sub-writes."""
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.core import PartitionPolicy as RefPolicy
    from repro.core.store import PartialWriteError as RefPartial

    def flow(mod, store, policy, state, like, err_type):
        real = store.put_batch

        def killed(names, blobs, xattrs=None, **kw):
            it = iter(blobs)
            return real(names, (b for _, b in zip(range(len(names) // 2),
                                                  it)), xattrs, **kw)

        store.put_batch = killed
        with pytest.raises(err_type) as ei:
            mod.save(store, state, 1, policy=policy, window_bytes=16 << 10)
        store.put_batch = real
        assert ei.value.persisted
        assert mod.latest_step(store) is None
        deleted = mod.reconcile_partial_save(store, ei.value)
        assert sorted(deleted) == sorted(n for n, _ in ei.value.persisted)
        assert not any(n.startswith("ckpt/") for n in store.list_objects())
        mod.save(store, state, 1, policy=policy, window_bytes=16 << 10)
        restored, manifest = mod.restore(store, like)
        return sorted(ei.value.persisted), restored, _objects(store)

    w = np.arange(9000, dtype=np.float64)
    b = np.linspace(-1, 1, 5000, dtype=np.float32)
    ref = flow(ref_ckpt, _ref_store(4, replicas=2),
               RefPolicy(target_object_bytes=8 << 10,
                         max_object_bytes=64 << 10),
               {"w": w, "b": b}, {"w": np.empty_like(w),
                                  "b": np.empty_like(b)}, RefPartial)
    pt = flow(ckpt, make_store(4, replicas=2),
              PartitionPolicy(target_object_bytes=8 << 10,
                              max_object_bytes=64 << 10),
              {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
              {"w": torch.empty(9000, dtype=torch.float64),
               "b": torch.empty(5000)}, PartialWriteError)
    assert pt[0] == ref[0]
    assert pt[2] == ref[2]
    assert np.array_equal(pt[1]["w"].numpy(), w)
    assert np.array_equal(pt[1]["b"].numpy(), b)


# ------------------------------------------------------------- KV pages
L, B, H, D = 3, 2, 4, 16


def _cache_leaves(S, seed=0) -> dict[str, tuple[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return {
        "k": ("bfloat16", _bf16_bits(rng, (L, B, S, H, D))),
        "v": ("bfloat16", _bf16_bits(rng, (L, B, S, H, D))),
        "ssm": ("float32", rng.normal(size=(L, B, 8)).astype(np.float32)),
        "pos": ("int32", np.asarray(S - 1, np.int32)),
    }


def _cache(make, S):
    c = {k: make(*v) for k, v in _cache_leaves(S).items()}
    return {"layers": {"k": c["k"], "v": c["v"], "ssm": c["ssm"]},
            "pos": c["pos"]}


def _seq_axes(cache) -> dict[str, int]:
    """As the serving engine parks a session: 'k', 'v', 'ckv' and
    'krope' leaves on axis 2 of (L, B, S, ...)."""
    return {key: 2 for key, _ in pytree.flatten_with_keys(cache)
            if any(t in key for t in ("'k'", "'v'", "'ckv'", "'krope'"))}


@pytest.mark.parametrize("S", [1, 2048, 5000])
def test_kv_pages_byte_equal_and_restore_across_packages(S):
    from repro.serve import kvcache as ref_kv
    pt_cache = _cache(_torch_leaf, S)
    axes = _seq_axes(pt_cache)
    assert sorted(axes) == ["['layers']['k']", "['layers']['v']"]
    rs, ps = _ref_store(4, replicas=2), make_store(4, replicas=2)
    ref_m = ref_kv.cache_to_objects(rs, _cache(_jax_leaf, S), "s1",
                                    seq_axes=axes)
    pt_m = kvcache.cache_to_objects(ps, pt_cache, "s1", seq_axes=axes)
    assert json.dumps(pt_m) == json.dumps(ref_m)
    pages = -(-S // kvcache.PAGE_TOKENS)
    assert len(pt_m["leaves"]["['layers']['k']"]["pages"]) == pages
    assert _objects(ps) == _objects(rs)
    # the reference's pages restored by the port, and the port's by the
    # reference, each into its own like-tree
    got = kvcache.objects_to_cache(make_store_from(rs),
                                   _cache(_torch_leaf, S), "s1")
    for (k, a), (_, b) in zip(pytree.flatten_with_keys(got),
                              pytree.flatten_with_keys(pt_cache)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _raw(a) == _raw(b), k
    back = ref_kv.objects_to_cache(
        ref_store_from(ps), _cache(lambda d, v: np.asarray(_jax_leaf(d, v)),
                                   S), "s1")
    for (k, a), (_, b) in zip(pytree.flatten_with_keys(back),
                              pytree.flatten_with_keys(pt_cache)):
        assert _raw(a) == _raw(b), k


# ----------------------------------------------------------- on the card
@pytest.mark.gpu
def test_checkpoint_and_kv_pages_on_the_card():
    """Leaves on the card save, restore onto the card bit-exactly, and
    a mutation right after ``maybe_save`` does not reach the store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    store = make_store(4, replicas=2)
    state = pytree.map_with_keys(lambda _k, t: t.to(dev),
                                 _tree(_torch_leaf))
    host = pytree.map_with_keys(lambda _k, t: t.clone(), _tree(_torch_leaf))
    mgr = ckpt.CheckpointManager(store, every_steps=1, keep=1)
    assert mgr.maybe_save(state, 1)
    state["opt"]["m"].add_(1.0)
    mgr.wait()
    got, _ = ckpt.restore(store, state)
    for (k, a), (_, b) in zip(pytree.flatten_with_keys(got),
                              pytree.flatten_with_keys(host)):
        assert a.device == dev and torch.equal(a.cpu(), b), k
    cache = pytree.map_with_keys(lambda _k, t: t.to(dev),
                                 _cache(_torch_leaf, 5000))
    kvcache.cache_to_objects(store, cache, "s", seq_axes=_seq_axes(cache))
    like = pytree.map_with_keys(lambda _k, t: torch.empty_like(t), cache)
    back = kvcache.objects_to_cache(store, like, "s")
    for (k, a), (_, b) in zip(pytree.flatten_with_keys(back),
                              pytree.flatten_with_keys(cache)):
        assert a.device == dev and torch.equal(a, b), k
