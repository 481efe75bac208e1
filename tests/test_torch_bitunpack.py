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
NS = (0, 1, 31, 32, 33, 129, 1000, 4096)


def _values(bits, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


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


@pytest.mark.parametrize("bits", (1, 7, 13, 17))
def test_bitunpack_words_matches_pallas_interpret(bits):
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
@pytest.mark.parametrize("bits", BITS)
def test_kernel_matches_plain_on_card(card, bits):
    for n in NS + ((1 << 21) + 5,):
        words = ref_fmt.bitpack_encode(_values(bits, n, bits * n + 1), bits)
        w = torch.from_numpy(words.view(np.int32)).reshape(-1, bits)
        before = bu.launches
        got = bu.bitunpack_groups(w.to(card), bits, n)
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
