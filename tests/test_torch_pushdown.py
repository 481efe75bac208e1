"""The port's device pushdown (core.pushdown_torch) against the
reference's (core.pushdown_jax): the codec decode bit-exact, the filter
-> agg partials at rtol 3e-5 / atol 1e-3, unsharded and on a 2-rank
gloo DeviceMesh where each rank passes its half.

JAX is imported inside the tests that use it."""

import multiprocessing
import queue
import time

import numpy as np
import pytest
import torch

from repro.core.format import bitpack_encode
from repro_torch.core import pushdown_torch as pdt
from repro_torch.distributed import sharding as shd

KEYS = ("sum", "count", "min", "max")


def _np(d: dict) -> dict:
    return {k: np.float32(float(d[k])) for k in KEYS}


@pytest.mark.parametrize("bits", [1, 11, 17, 32])
def test_unpack_bitpacked_matches_reference(bits):
    import jax.numpy as jnp

    from repro.core import pushdown_jax
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << bits, 4096, dtype=np.uint64).astype(np.uint32)
    words = bitpack_encode(vals, bits)
    assert words.shape == pdt.packed_shape(4096, bits) \
        == pushdown_jax.packed_shape(4096, bits)
    got = pdt.unpack_bitpacked(torch.from_numpy(words.view(np.int32)), bits)
    want = pushdown_jax.unpack_bitpacked(jnp.asarray(words), bits)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy().view(np.uint32), vals)
    # leading batch dims, as the ingest path passes them
    batched = words.reshape(4, 32, bits)
    got = pdt.unpack_bitpacked(torch.from_numpy(batched.view(np.int32)), bits)
    want = pushdown_jax.unpack_bitpacked(jnp.asarray(batched), bits)
    assert got.shape == (4, 1024)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_unpack_bitpacked_rejects_wrong_width():
    with pytest.raises(ValueError, match="bits"):
        pdt.unpack_bitpacked(torch.zeros((4, 7), dtype=torch.int32), 8)


def test_packed_shape_rounds_up():
    assert pdt.packed_shape(33, 5) == (2, 5)
    assert pdt.packed_shape(0, 5) == (0, 5)


@pytest.mark.parametrize("cmp", ["<", "<=", ">", ">=", "==", "!="])
def test_pushdown_filter_aggregate_no_mesh(cmp):
    import jax.numpy as jnp

    from repro.core import pushdown_jax
    rng = np.random.default_rng(4)
    v = rng.normal(size=1000).astype(np.float32)
    f = rng.integers(0, 10, 1000).astype(np.float32)
    got = _np(pdt.pushdown_filter_aggregate(torch.from_numpy(v),
                                            torch.from_numpy(f), cmp, 5.0))
    want = _np(pushdown_jax.pushdown_filter_aggregate(
        jnp.asarray(v), jnp.asarray(f), cmp, 5.0))
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-5, atol=1e-3)
    assert got["count"] == want["count"]
    assert got["min"] == want["min"] and got["max"] == want["max"]


def test_pushdown_int_filter_compares_in_its_dtype():
    import jax.numpy as jnp

    from repro.core import pushdown_jax
    rng = np.random.default_rng(5)
    v = rng.gamma(2.0, 20.0, 5000).astype(np.float32)
    run = rng.integers(0, 100, 5000).astype(np.int32)
    got = _np(pdt.pushdown_filter_aggregate(torch.from_numpy(v),
                                            torch.from_numpy(run), "<", 50))
    want = _np(pushdown_jax.pushdown_filter_aggregate(
        jnp.asarray(v), jnp.asarray(run), "<", 50))
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=3e-5)
    assert got["count"] == want["count"] == (run < 50).sum()


def test_shard_local_returns_fn_with_and_without_rules():
    def fn(x):
        return x + 1

    assert shd.active_rules() is None
    assert pdt.shard_local(fn, out_specs=None) is fn

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")

    rules = shd.MeshRules(_Mesh(), strategy="fsdp")
    assert rules.dp_axes == ("pod", "data")
    assert rules.all_axes == ("pod", "data", "model")
    with shd.use_rules(rules):
        assert shd.active_rules() is rules
        assert pdt.shard_local(fn, out_specs=None, in_axes="dp") is fn
    assert shd.active_rules() is None
    with pytest.raises(ValueError, match="strategy"):
        shd.MeshRules(_Mesh(), strategy="nope")


# ------------------------------------------------ 2-rank gloo DeviceMesh
def _mesh_worker(rank, world, init, v, f, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        half = len(v) // world
        sl = slice(rank * half, (rank + 1) * half)
        with shd.use_rules(shd.MeshRules(mesh)):
            res = pdt.pushdown_filter_aggregate(
                torch.from_numpy(v[sl]), torch.from_numpy(f[sl]), "<", 25)
        out.put((rank, {k: float(res[k]) for k in KEYS}))
    finally:
        dist.destroy_process_group()


def test_pushdown_filter_aggregate_on_a_two_rank_mesh(tmp_path):
    import jax.numpy as jnp

    from repro.kernels import ref as jax_ref
    rng = np.random.default_rng(6)
    n = 20_000
    v = rng.normal(size=n).astype(np.float32)
    f = rng.integers(0, 50, n).astype(np.float32)
    v[3] = -50.0           # the minimum lies in rank 0's half ...
    f[3] = 1.0
    v[n - 3] = 60.0        # ... the maximum in rank 1's
    f[n - 3] = 2.0
    out = multiprocessing.get_context("spawn").Queue()
    ctx = torch.multiprocessing.spawn(
        _mesh_worker, args=(2, f"file://{tmp_path}/pg", v, f, out),
        nprocs=2, join=False)
    # a hung rank fails the test within 60 s instead of hanging the suite;
    # the queue is drained before the join
    deadline = time.monotonic() + 60.0
    got = {}
    try:
        while len(got) < 2:
            try:
                rank, res = out.get(timeout=1.0)
                got[rank] = res
            except queue.Empty:
                ctx.join(timeout=0.01)     # re-raises a failed rank's error
                if time.monotonic() > deadline:
                    raise AssertionError("a gloo rank did not finish in 60 s")
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError("a gloo rank did not exit in 60 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    want = _np(jax_ref.filter_agg_ref(jnp.asarray(v), jnp.asarray(f), "<",
                                      25))
    for rank in (0, 1):
        r = _np(got[rank])
        for k in KEYS:
            np.testing.assert_allclose(r[k], want[k], rtol=3e-5, atol=1e-3)
        assert r["count"] == want["count"]
        assert r["min"] == want["min"] == np.float32(-50.0)
        assert r["max"] == want["max"] == np.float32(60.0)

