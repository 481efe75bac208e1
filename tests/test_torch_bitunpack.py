"""The port's bitunpack (plain version on the CPU, CUDA kernel on a card)
against the reference's numpy codec, Pallas kernel (interpret mode) and
oracle.  All comparisons are bit-exact: the codec is integer-only.

The JAX side is imported inside the tests that use it, so the card's
tests (``-m gpu``) also collect where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro.core import format as ref_fmt
from repro_torch.kernels import bitunpack as bu
from repro_torch.kernels import ref as torch_ref

BITS = (1, 5, 7, 8, 13, 16, 17, 20, 24, 31, 32)
ALL_BITS = tuple(range(1, 33))
NS = (0, 1, 31, 32, 33, 129, 1000, 4096)
OFFSETS = (1, 2, 3)              # words past a 16-byte line
N_SMS = 132                      # an H100 SXM


def _values(bits, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


@pytest.fixture()
def ref_numpy_decode():
    """The reference's decode pinned to its bit-exact numpy codec, and
    restored afterwards."""
    ref_fmt.set_bitunpack_backend("numpy")
    yield
    ref_fmt.set_bitunpack_backend("auto")


def _offset_view(words: np.ndarray, offset: int, shape,
                 device="cpu") -> torch.Tensor:
    """``words`` as an int32 view ``offset`` words into a larger tensor
    on ``device``."""
    flat = np.zeros(offset + words.size + 3, np.uint32)
    flat[offset:offset + words.size] = words.reshape(-1)
    buf = torch.from_numpy(flat.view(np.int32)).to(device)
    return buf[offset:offset + words.size].view(shape)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("bits", BITS)
def test_bitunpack_words_matches_numpy_codec(bits):
    for n in NS:
        words = ref_fmt.bitpack_encode(_values(bits, n, bits * 7919 + n),
                                       bits)
        got = bu.bitunpack_words(words, bits, n, device="cpu")
        assert got.dtype == np.uint32 and got.shape == (n,)
        assert np.array_equal(got, ref_fmt.bitpack_decode(words, bits, n))


@pytest.mark.parametrize("bits", ALL_BITS)
def test_bitunpack_words_matches_pallas_interpret(bits, ref_numpy_decode):
    from repro.kernels.bitunpack import bitunpack_words as jax_bitunpack_words
    for n in NS:
        words = ref_fmt.bitpack_encode(_values(bits, n, bits + 3 * n), bits)
        want = jax_bitunpack_words(words, bits, n, interpret=True)
        got = bu.bitunpack_words(words, bits, n, device="cpu")
        assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", (1, 8, 17, 24, 32))
def test_bitunpack_tiles_match_reference_oracle(bits):
    import jax.numpy as jnp

    from repro.kernels import ref as jax_ref
    rng = np.random.default_rng(bits)
    words = rng.integers(0, 1 << 32, (3, 4, bits), dtype=np.uint64
                         ).astype(np.uint32)
    want = np.asarray(jax_ref.bitunpack_ref(jnp.asarray(words), bits))
    t = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(bu.bitunpack(t, bits=bits).numpy(), want)
    assert np.array_equal(torch_ref.bitunpack_ref(t, bits).numpy(), want)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("bits", (1, 7, 17, 32))
def test_offset_views_match_pallas_interpret(bits, offset, ref_numpy_decode):
    """unpack_bitpacked and ops.bitunpack_tokens pass a caller's view
    straight to the decode: a packed batch that starts 1-3 words into a
    larger tensor decodes as the reference's kernel decodes its words."""
    from repro.kernels.bitunpack import bitunpack_words as jax_bitunpack_words
    from repro_torch.core.pushdown_torch import unpack_bitpacked
    from repro_torch.kernels import ops

    B, G = 3, 8
    words = ref_fmt.bitpack_encode(_values(bits, B * G * 32, bits + offset),
                                   bits)
    want = jax_bitunpack_words(words, bits, B * G * 32, interpret=True
                               ).view(np.int32).reshape(B, G * 32)
    view = _offset_view(words, offset, (B, G, bits))
    assert view.storage_offset() == offset
    assert np.array_equal(unpack_bitpacked(view, bits).numpy(), want)
    assert np.array_equal(ops.bitunpack_tokens(view, bits=bits).numpy(), want)


@pytest.mark.parametrize("bits", (1, 7, 17, 32))
@pytest.mark.parametrize("n_groups", (1, 31, 33, 263, 264, 8_191, 21_760,
                                      32_768, 67_585, 1 << 23, (1 << 23) + 5))
def test_launch_plan_covers_every_group_once(n_groups, bits):
    """The grid-stride walk (CTA b takes tiles b, b + grid, ...) visits
    every tile once, and the tiles cover the groups exactly."""
    plan = bu.launch_plan(n_groups, bits, N_SMS)
    assert plan.tile in bu.TILES and 1 <= plan.grid <= plan.n_tiles
    walk = np.concatenate([np.arange(b, plan.n_tiles, plan.grid)
                           for b in range(plan.grid)])
    assert np.array_equal(np.sort(walk), np.arange(plan.n_tiles))
    assert (plan.n_tiles - 1) * plan.tile < n_groups <= plan.n_tiles * plan.tile
    # a tile as big as the column allows while every SM gets two
    if plan.tile != bu.TILES[-1]:
        assert plan.n_tiles >= 2 * N_SMS
    if plan.tile != bu.TILES[0]:
        assert -(-n_groups // (2 * plan.tile)) < 2 * N_SMS


@pytest.mark.parametrize("bits", ALL_BITS)
def test_launch_plan_stages_stay_aligned_and_fit(bits):
    """Each stage starts on a 16-byte line and holds a tile's words at
    any of the four word offsets; the CTAs of one SM fit in its shared
    memory, and no CTA asks for more than 227 KB (at bits = 32 too)."""
    for tile in bu.TILES:
        n_groups = tile * 2 * N_SMS         # the plan that picks this tile
        plan = bu.launch_plan(n_groups, bits, N_SMS)
        assert plan.tile == tile
        stride = tile * bits + 4            # words per stage
        assert plan.smem_bytes == bu.STAGES * stride * 4
        assert (stride * 4) % 16 == 0       # every stage on a 16-byte line
        assert stride >= 3 + tile * bits    # a line offset of 3 words fits
        assert plan.smem_bytes <= 232_448
        per_sm = -(-plan.grid // N_SMS)
        assert per_sm <= bu.BLOCKS_PER_SM
        assert per_sm * (plan.smem_bytes + bu.SMEM_RESERVED) <= bu.SMEM_PER_SM
    assert bu.launch_plan(1 << 23, 32, N_SMS).smem_bytes == 98_352


def test_launch_plan_at_the_main_path_shapes():
    # the scan's object column: 696,320 values of bitpack7
    assert bu.launch_plan(21_760, 7, N_SMS) == bu.LaunchPlan(64, 340, 340,
                                                            5_424)
    # the ingest batch: 256 x 4096 tokens of bitpack17
    assert bu.launch_plan(32_768, 17, N_SMS) == bu.LaunchPlan(64, 512, 512,
                                                             13_104)
    # 2^28 values of bitpack17: a persistent grid, four CTAs per SM
    assert bu.launch_plan(1 << 23, 17, N_SMS) == bu.LaunchPlan(
        256, 32_768, 528, 52_272)


def test_unaligned_readonly_words_decode():
    """Block columns are read-only views at any byte offset."""
    bits, n = 9, 500
    words = ref_fmt.bitpack_encode(_values(bits, n, 1), bits)
    buf = b"x" + words.tobytes()
    view = np.frombuffer(memoryview(buf)[1:], dtype=np.uint32)
    assert not view.flags["ALIGNED"] and not view.flags["WRITEABLE"]
    got = bu.bitunpack_words(view, bits, n, device="cpu")
    assert np.array_equal(got, ref_fmt.bitpack_decode(words, bits, n))


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        bu.bitunpack(torch.zeros((1, 4, 3), dtype=torch.int64), bits=3)
    with pytest.raises(ValueError):
        bu.bitunpack(torch.zeros((1, 4, 3), dtype=torch.int32), bits=4)
    with pytest.raises(ValueError):
        bu.bitunpack_words(np.zeros(7, np.uint32), 3, 10, device="cpu")
    with pytest.raises(ValueError):
        bu.bitunpack_words(np.zeros(6, np.uint32), 3, 65, device="cpu")


def test_cpu_decode_does_not_launch():
    before = bu.launches
    bu.bitunpack_words(ref_fmt.bitpack_encode(_values(5, 64, 2), 5), 5, 64,
                       device="cpu")
    assert bu.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0,) + OFFSETS)
@pytest.mark.parametrize("bits", ALL_BITS)
def test_kernel_matches_plain_on_card(card, bits, offset):
    """Every width, with the words on a 16-byte line and 1-3 words past
    one (a view into a larger tensor on the card)."""
    for n in NS + ((1 << 21) + 5,):
        words = ref_fmt.bitpack_encode(_values(bits, n, bits * n + 1), bits)
        w = torch.from_numpy(words.view(np.int32)).reshape(-1, bits)
        on_card = _offset_view(words, offset, (-1, bits), card)
        if n:
            assert on_card.data_ptr() % 16 == 4 * offset
        before = bu.launches
        got = bu.bitunpack_groups(on_card, bits, n)
        torch.cuda.synchronize()
        assert bu.launches == before + (1 if n else 0)
        assert torch.equal(got.cpu(), bu.bitunpack_plain(w, bits, n))
        assert np.array_equal(bu.bitunpack_words(words, bits, n),
                              ref_fmt.bitpack_decode(words, bits, n))


def test_first_build_runs_once_across_threads(monkeypatch):
    """Scans decode on pool threads: many can reach the first launch
    together, and exactly one of them builds."""
    import ctypes.util
    import sys
    import threading

    from repro_torch.kernels import _build

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a built kernel")
    builds = []

    def slow_compile(name):
        builds.append(name)
        threading.Event().wait(0.05)
        return libc

    monkeypatch.setattr(_build, "_compile", slow_compile)
    monkeypatch.setattr(_build, "_libs", {})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            _build.load("standin"))) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert builds == ["standin"]
    assert len(got) == 32 and all(lib is got[0] for lib in got)


@pytest.mark.gpu
def test_launch_count_exact_under_threads(card):
    import threading

    words = ref_fmt.bitpack_encode(_values(11, 5000, 3), 11)
    want = ref_fmt.bitpack_decode(words, 11, 5000)
    bu.ensure_built()
    before = bu.launches
    bad = []

    def work():
        for _ in range(25):
            if not np.array_equal(bu.bitunpack_words(words, 11, 5000), want):
                bad.append(1)

    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not bad and bu.launches == before + 16 * 25
