"""The port's kernels.ops (plain versions on the CPU, CUDA kernels on a
card) against the reference's ops (Pallas kernels in interpret mode on
the CPU), with the same numpy inputs: the sweeps of
tests/test_kernels.py plus the edges a float32 reduction can get wrong
(empty selection, NaN, a threshold that is not a float32, the ragged
last tile).  Float sums compare at the reference's own rtol 3e-5 /
atol 1e-3; counts, minima, maxima and identities exactly.

JAX is imported inside the tests that use it, so the card's tests
(``-m gpu``) also collect where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro.core import format as ref_fmt
from repro_torch.core import format as pt_fmt
from repro_torch.core import objclass as pt_oc
from repro_torch.kernels import block_agg as ba
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref

CMPS = ("<", "<=", ">", ">=", "==", "!=")
KEYS = ("sum", "count", "min", "max")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _jax_ops():
    from repro.kernels import ops as jax_ops
    return jax_ops


def _np(d: dict) -> dict:
    return {k: np.float32(float(d[k])) for k in KEYS}


def _close(got: dict, want: dict) -> None:
    got, want = _np(got), _np(want)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-5, atol=1e-3,
                                   err_msg=k)
    assert got["min"] == want["min"] and got["max"] == want["max"]


def _same(got: dict, want: dict) -> None:
    got, want = _np(got), _np(want)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_filter(v, f, cmp, thr):
    import jax.numpy as jnp
    return _jax_ops().filter_aggregate(jnp.asarray(v), jnp.asarray(f),
                                       cmp, thr)


def _jax_masked(v, m):
    import jax.numpy as jnp
    return _jax_ops().masked_aggregate(jnp.asarray(v, jnp.float32),
                                       jnp.asarray(m))


@pytest.mark.parametrize("cmp", CMPS)
@pytest.mark.parametrize("n", [8192, 12345])
def test_filter_aggregate_matches_reference(cmp, n):
    rng = np.random.default_rng(CMPS.index(cmp) * 100 + n)
    v = rng.normal(size=n).astype(np.float32)
    f = rng.integers(0, 50, n).astype(np.float32)
    got = ops.filter_aggregate(torch.from_numpy(v), torch.from_numpy(f),
                               cmp, 25)
    _close(got, _jax_filter(v, f, cmp, 25))
    _close(got, torch_ref.filter_agg_ref(torch.from_numpy(v),
                                         torch.from_numpy(f), cmp, 25))


@pytest.mark.parametrize("cmp", CMPS)
def test_filter_aggregate_int32_columns(cmp):
    rng = np.random.default_rng(5)
    n = 9000
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    f = rng.integers(0, 50, n).astype(np.int32)
    got = ops.filter_aggregate(torch.from_numpy(v), torch.from_numpy(f),
                               cmp, 25)
    _close(got, _jax_filter(v, f, cmp, 25))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n", [8192, 9000, 40000])
def test_masked_aggregate_matches_reference(dtype, n):
    rng = np.random.default_rng(n)
    v = (rng.normal(size=n) * 10).astype(dtype)
    m = rng.random(n) < 0.5
    got = ops.masked_aggregate(torch.from_numpy(v), torch.from_numpy(m))
    _close(got, _jax_masked(v, m))
    _close(got, torch_ref.block_agg_ref(torch.from_numpy(v),
                                        torch.from_numpy(m)))


@pytest.mark.parametrize("mask_dtype", [np.int32, np.uint8, np.float32])
def test_masked_aggregate_mask_dtypes(mask_dtype):
    rng = np.random.default_rng(3)
    n = 10_000
    v = rng.normal(size=n).astype(np.float32)
    m = (rng.random(n) * 3).astype(mask_dtype)   # 0, 1, 2 (floats truncate)
    got = ops.masked_aggregate(torch.from_numpy(v), torch.from_numpy(m))
    _close(got, _jax_masked(v, m))


def test_empty_selection_gives_the_reference_identities():
    v = np.ones(8192, np.float32)
    f = np.zeros(8192, np.float32)
    got = ops.filter_aggregate(torch.from_numpy(v), torch.from_numpy(f),
                               ">", 1.0)
    _same(got, _jax_filter(v, f, ">", 1.0))
    assert _np(got)["min"] == np.float32(3.4e38)
    assert _np(got)["max"] == np.float32(-3.4e38)
    m = np.zeros(9000, bool)
    _same(ops.masked_aggregate(torch.ones(9000), torch.from_numpy(m)),
          _jax_masked(np.ones(9000, np.float32), m))


def test_zero_rows_give_the_identities():
    empty = torch.zeros(0)
    want = {"sum": 0.0, "count": 0.0, "min": np.float32(3.4e38),
            "max": np.float32(-3.4e38)}
    _same(ops.filter_aggregate(empty, empty, "<", 1.0), want)
    _same(ops.masked_aggregate(empty, empty.bool()), want)


@pytest.mark.parametrize("cmp", CMPS)
def test_nan_values_and_nan_filter(cmp):
    n = 12345
    rng = np.random.default_rng(11)
    v = rng.normal(size=n).astype(np.float32)
    f = rng.integers(0, 50, n).astype(np.float32)
    v[100] = np.nan            # selected or not, depending on f[100]
    f[100] = 10.0
    f[9000] = np.nan           # fails every comparator but !=
    v[9000] = 1e6
    got = ops.filter_aggregate(torch.from_numpy(v), torch.from_numpy(f),
                               cmp, 25)
    want = _np(_jax_filter(v, f, cmp, 25))
    got = _np(got)
    for k in KEYS:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=3e-5,
                                       atol=1e-3, err_msg=k)
    assert got["count"] == want["count"]


def test_selected_nan_propagates_in_masked_aggregate():
    v = np.arange(9000, dtype=np.float32)
    v[8500] = np.nan
    m = np.ones(9000, bool)
    got = _np(ops.masked_aggregate(torch.from_numpy(v), torch.from_numpy(m)))
    want = _np(_jax_masked(v, m))
    for k in ("sum", "min", "max"):
        assert np.isnan(got[k]) and np.isnan(want[k])
    assert got["count"] == want["count"] == 9000


@pytest.mark.parametrize("cmp", CMPS)
def test_threshold_rounds_to_float32(cmp):
    """0.1 is no float32: the compare is f32(filter) cmp f32(0.1)."""
    t = np.float32(0.1)
    near = [np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))]
    f = np.array(near * 3000, np.float32)
    v = np.ones(f.size, np.float32)
    got = _np(ops.filter_aggregate(torch.from_numpy(v), torch.from_numpy(f),
                                   cmp, 0.1))
    want = _np(_jax_filter(v, f, cmp, 0.1))
    assert got["count"] == want["count"]
    _same(got, want)


@pytest.mark.parametrize("n", [1, 8191, 8193, 3 * 8192 + 5])
def test_per_tile_partials_match_reference(n):
    import jax.numpy as jnp

    from repro.kernels import block_agg as jax_ba
    from repro.kernels import filter_agg as jax_fa
    rng = np.random.default_rng(n)
    tile = 8192
    pad = (-n) % tile
    v = rng.normal(size=n).astype(np.float32)
    f = rng.integers(0, 50, n).astype(np.float32)
    m = rng.random(n) < 0.3
    got = fa.filter_agg(torch.from_numpy(v), torch.from_numpy(f), "<", 25)
    want = jax_fa.filter_agg(
        jnp.pad(jnp.asarray(v), (0, pad)),
        jnp.pad(jnp.asarray(f), (0, pad), constant_values=np.nan),
        "<", 25.0, interpret=True)
    assert got.shape == (-(-n // tile), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               rtol=3e-5, atol=1e-3)
    got = ba.block_agg(torch.from_numpy(v), torch.from_numpy(m))
    want = jax_ba.block_agg(jnp.pad(jnp.asarray(v), (0, pad)),
                            jnp.pad(jnp.asarray(m, jnp.int32), (0, pad)),
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               rtol=3e-5, atol=1e-3)


def test_combine_partials_propagates_nan():
    p = torch.tensor([[1.0, 1.0, 1.0, 1.0], [np.nan, 1.0, np.nan, np.nan]])
    got = fa.combine_partials(p)
    assert torch.isnan(got["min"]) and torch.isnan(got["max"])
    assert got["count"] == 2.0


@pytest.mark.parametrize("bits", [1, 5, 8, 13, 16, 17, 20])
@pytest.mark.parametrize("shape", [(1, 128), (4, 512), (2, 1024)])
def test_bitunpack_tokens_matches_reference(bits, shape):
    import jax.numpy as jnp
    rng = np.random.default_rng(bits)
    B, S = shape
    toks = rng.integers(0, 1 << bits, (B, S)).astype(np.int32)
    words = ref_fmt.bitpack_encode(toks.ravel(), bits).reshape(B, S // 32,
                                                              bits)
    got = ops.bitunpack_tokens(torch.from_numpy(words.view(np.int32)),
                               bits=bits)
    want = _jax_ops().bitunpack_tokens(jnp.asarray(words), bits=bits)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), toks)


def test_bitunpack_tokens_shape_errors():
    with pytest.raises(ValueError, match="bad packed shape"):
        ops.bitunpack_tokens(torch.zeros((2, 6, 5), dtype=torch.int32),
                             bits=5)                 # G % 4
    with pytest.raises(ValueError, match="bad packed shape"):
        ops.bitunpack_tokens(torch.zeros((2, 8, 5), dtype=torch.int32),
                             bits=6)                 # b != bits


def test_select_packed_then_bitunpack_tokens():
    """Object bytes -> select_packed -> bitunpack_tokens == raw tokens,
    on objects written by both packages (byte-identical blobs)."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 100_000, (16, 128)).astype(np.int32)
    bits = pt_fmt.bitpack_width(100_000 - 1)
    blob = pt_fmt.encode_block({"tokens": toks},
                               codecs={"tokens": f"bitpack{bits}"})
    assert blob == ref_fmt.encode_block({"tokens": toks},
                                        codecs={"tokens": f"bitpack{bits}"})
    res = pt_oc.select_packed(blob, rows=(3, 11), col="tokens")
    out = ops.bitunpack_tokens(
        torch.from_numpy(np.ascontiguousarray(res["packed"]).view(np.int32)),
        bits=int(res["bits"]))
    assert np.array_equal(out.numpy(), toks[3:11])


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError, match="comparator"):
        ops.filter_aggregate(torch.ones(4), torch.ones(4), "<>", 1)
    with pytest.raises(ValueError, match="columns"):
        ops.filter_aggregate(torch.ones(4), torch.ones(5), "<", 1)
    with pytest.raises(ValueError, match="columns"):
        ops.masked_aggregate(torch.ones((2, 2)), torch.ones((2, 2)))


# -------------------------------------------------------------- the card
def _card_values(rng, n, dtype):
    """Unit normals (tile sums stay where atol 1e-3 holds), or integers
    whose tile sums are exact in float32."""
    if dtype == np.int32:
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.normal(size=n).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("cmp", CMPS)
def test_filter_agg_kernel_matches_plain_on_card(card, cmp):
    rng = np.random.default_rng(1)
    for n in (1, 8191, 8192, 12345, (1 << 20) + 3):
        for vt, ft in ((np.float32, np.float32), (np.int32, np.int32),
                       (np.float32, np.int32)):
            v = torch.from_numpy(_card_values(rng, n, vt))
            f = torch.from_numpy(rng.integers(0, 50, n).astype(ft))
            before = fa.launches
            got = fa.filter_agg(v.to(card), f.to(card), cmp, 25)
            assert fa.launches == before + 1
            want = fa.filter_agg_plain(v.to(card), f.to(card), cmp, 25)
            torch.cuda.synchronize()
            torch.testing.assert_close(got[:, :2], want[:, :2], rtol=3e-5,
                                       atol=1e-3)
            assert torch.equal(got[:, 2:], want[:, 2:])


@pytest.mark.gpu
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_block_agg_kernel_matches_plain_on_card(card, mask_dtype):
    rng = np.random.default_rng(2)
    for n in (1, 8191, 8192, 12345, (1 << 20) + 3):
        for vt in (np.float32, np.int32):
            v = torch.from_numpy(_card_values(rng, n, vt))
            m = torch.from_numpy(rng.random(n) < 0.4).to(mask_dtype)
            got = ba.block_agg(v.to(card), m.to(card))
            want = ba.block_agg_plain(v.to(card), m.to(card))
            torch.cuda.synchronize()
            torch.testing.assert_close(got[:, :2], want[:, :2], rtol=3e-5,
                                       atol=1e-3)
            assert torch.equal(got[:, 2:], want[:, 2:])


@pytest.mark.gpu
def test_kernels_edges_on_card(card):
    """Misaligned columns (scalar path), NaN, empty selection, N = 0."""
    v = torch.arange(20_001, dtype=torch.float32, device=card)
    f = torch.arange(20_001, dtype=torch.float32, device=card)
    got = ops.filter_aggregate(v[1:], f[1:], "<", 500.5)     # 4-byte offset
    want = torch_ref.filter_agg_ref(v[1:], f[1:], "<", 500.5)
    _close(got, want)
    v[7] = float("nan")
    got = ops.masked_aggregate(v, f < 10)
    assert all(torch.isnan(got[k]) for k in ("sum", "min", "max"))
    got = ops.filter_aggregate(v, f, ">", 1e9)
    _same(got, {"sum": 0.0, "count": 0.0, "min": np.float32(3.4e38),
                "max": np.float32(-3.4e38)})
    before = fa.launches
    ops.filter_aggregate(v[:0], f[:0], "<", 1)
    assert fa.launches == before
