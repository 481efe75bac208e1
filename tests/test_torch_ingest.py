"""The port's packed-ingest path (data/: corpus, pipeline, fused_ingest)
against the reference's (repro.data), with the same specs and seeds:
packed words, corpus objects, every loader batch (plain, packed,
prefetched, windowed, resumed, rank-sliced, hedged) and the fabric's
integer counters must be exactly equal.  Wall-clock fields (``*_s``)
are left out of the counters.

JAX is imported inside the tests that use it."""

import numpy as np
import pytest
import torch

from repro.core import GlobalVOL as RefVOL
from repro.core import format as ref_fmt
from repro.core import make_store as ref_make_store
from repro.core.partition import PartitionPolicy as RefPolicy
from repro.data import corpus as ref_corpus
from repro.data import pipeline as ref_pipeline
from repro_torch.core import GlobalVOL as PtVOL
from repro_torch.core import format as pt_fmt
from repro_torch.core import make_store as pt_make_store
from repro_torch.core.partition import PartitionPolicy as PtPolicy
from repro_torch.data import corpus as pt_corpus
from repro_torch.data import fused_ingest as fi
from repro_torch.data import pipeline as pt_pipeline

SPEC = dict(n_seqs=256, seq_len=128, vocab_size=5000, seed=1)
POLICY = dict(target_object_bytes=32 << 10, max_object_bytes=256 << 10)


@pytest.fixture(scope="module", autouse=True)
def cpu_decode():
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


def _counters(d: dict) -> dict:
    return {k: v for k, v in d.items() if not k.endswith("_s")}


def _contents(store) -> dict:
    out = {}
    for osd_id, osd in store.osds.items():
        with osd.lock:
            out[osd_id] = (dict(osd.data), {k: dict(v) for k, v in
                                            osd.xattrs.items()})
    return out


def _world(pkg: str, n_osds=6, replicas=2, spec=SPEC, policy=POLICY):
    if pkg == "ref":
        store = ref_make_store(n_osds, replicas=replicas)
        vol = RefVOL(store)
        ref_corpus.build_corpus(vol, ref_corpus.CorpusSpec(**spec),
                                policy=RefPolicy(**policy))
    else:
        store = pt_make_store(n_osds, replicas=replicas)
        vol = PtVOL(store)
        pt_corpus.build_corpus(vol, pt_corpus.CorpusSpec(**spec),
                               policy=PtPolicy(**policy))
    return store, vol


@pytest.fixture(scope="module")
def worlds():
    ref, pt = _world("ref"), _world("pt")
    yield ref, pt
    ref[0].close()
    pt[0].close()


def _loader(pkg, vol, **kw):
    kw.setdefault("global_batch", 16)
    kw.setdefault("seed", 7)
    kw.setdefault("prefetch", 0)
    mod = ref_pipeline if pkg == "ref" else pt_pipeline
    return mod.ObjectDataLoader(vol, "corpus", **kw)


def _equal_batches(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------ fused_ingest
@pytest.mark.parametrize("bits", [5, 13, 17])
def test_pack_batch_matches_reference(bits):
    from repro.data import fused_ingest as ref_fi
    rng = np.random.default_rng(bits)
    toks = rng.integers(0, 1 << bits, (4, 256)).astype(np.int32)
    got, want = fi.pack_batch(toks, bits), ref_fi.pack_batch(toks, bits)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="multiple of 32"):
        fi.pack_batch(toks[:, :40], bits)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shape", [(2, 128), (3, 512), (1, 4096)])
def test_unpack_tokens_and_fused_batch_match_reference(use_kernel, shape):
    import jax.numpy as jnp

    from repro.data import fused_ingest as ref_fi
    rng = np.random.default_rng(shape[1])
    bits = 17
    toks = rng.integers(0, 102_400, shape).astype(np.int32)
    words = fi.pack_batch(toks, bits)
    t = torch.from_numpy(words.view(np.int32))
    got = fi.unpack_tokens(t, use_kernel=use_kernel)
    want = ref_fi.unpack_tokens(jnp.asarray(words), use_pallas=use_kernel,
                                interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), toks)
    labels = fi.derive_labels(got)
    assert np.array_equal(labels.numpy(),
                          np.asarray(ref_fi.derive_labels(jnp.asarray(toks))))
    fb, ref_fb = fi.fused_batch(t), ref_fi.fused_batch(jnp.asarray(words))
    for k in ("tokens", "labels"):
        assert np.array_equal(fb[k].numpy(), np.asarray(ref_fb[k])), k


def test_unpack_tokens_kernel_route_needs_whole_rows():
    t = torch.zeros((2, 6, 5), dtype=torch.int32)      # G = 6: not % 4
    with pytest.raises(ValueError, match="G % 4"):
        fi.unpack_tokens(t, use_kernel=True)
    assert fi.unpack_tokens(t).shape == (2, 192)


def test_make_fused_train_step_feeds_the_unpacked_batch():
    toks = np.arange(2 * 64, dtype=np.int32).reshape(2, 64)
    seen = {}

    def base(state, batch):
        seen.update(batch)
        return state + 1, {"n": batch["tokens"].numel()}

    step = fi.make_fused_train_step(base)
    state, metrics = step(0, torch.from_numpy(fi.pack_batch(toks, 8)
                                              .view(np.int32)))
    assert state == 1 and metrics == {"n": 128}
    assert np.array_equal(seen["tokens"].numpy(), toks)
    assert (seen["labels"][:, -1] == -1).all()


# ------------------------------------------------------------ corpus
def test_build_corpus_writes_identical_objects(worlds):
    (ref_store, ref_vol), (pt_store, pt_vol) = worlds
    ref_names = ref_vol.open("corpus").object_names()
    assert ref_names == pt_vol.open("corpus").object_names()
    assert len(ref_names) >= 4
    assert _contents(ref_store) == _contents(pt_store)


def test_synth_tokens_matches_reference():
    a = ref_corpus.synth_tokens(np.random.default_rng(3), 8, 96, 1000)
    b = pt_corpus.synth_tokens(np.random.default_rng(3), 8, 96, 1000)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of 32"):
        pt_corpus.CorpusSpec(seq_len=100).dataset()


# ------------------------------------------------------------ loader
@pytest.mark.parametrize("packed", [False, True])
def test_loader_batches_and_fabric_match_reference(worlds, packed):
    (ref_store, ref_vol), (pt_store, pt_vol) = worlds
    counts = []
    batches = []
    for pkg, store, vol in (("ref", ref_store, ref_vol),
                            ("pt", pt_store, pt_vol)):
        before = _counters(store.fabric.snapshot())
        ld = _loader(pkg, vol, packed=packed)
        batches.append([ld.make_batch(s) for s in range(4)])
        after = _counters(store.fabric.snapshot())
        counts.append({k: after[k] - before[k] for k in after})
    for a, b in zip(*batches):
        _equal_batches(a, b)
    assert counts[0] == counts[1]
    assert counts[1]["ops"] > 0 and counts[1]["client_rx"] > 0


def test_packed_words_decode_to_the_plain_batch(worlds):
    _, (_, vol) = worlds
    plain = _loader("pt", vol).make_batch(2)
    packed = _loader("pt", vol, packed=True).make_batch(2)
    fb = fi.fused_batch(torch.from_numpy(packed["tokens_packed"]
                                         .view(np.int32)))
    assert np.array_equal(fb["tokens"].numpy(), plain["tokens"])
    assert np.array_equal(fb["labels"].numpy(), plain["labels"])
    raw = plain["tokens"].nbytes + plain["labels"].nbytes
    assert packed["tokens_packed"].nbytes < raw / 3     # 13-bit vocab


@pytest.mark.parametrize("packed", [False, True])
def test_prefetch_and_windowed_batches_match_reference(worlds, packed):
    (_, ref_vol), (_, pt_vol) = worlds
    ref = _loader("ref", ref_vol, packed=packed)
    lds = [_loader("pt", pt_vol, packed=packed, prefetch=2),
           _loader("pt", pt_vol, packed=packed, prefetch=2, window_steps=2)]
    try:
        for s in range(5):
            want = ref.make_batch(s)
            for ld in lds:
                _equal_batches(next(ld), want)
        assert lds[1].last_window_stats["window_steps"] == 2
    finally:
        for ld in lds:
            ld.close()


def test_seek_resumes_exactly(worlds):
    (_, ref_vol), (_, pt_vol) = worlds
    ref = _loader("ref", ref_vol)
    ld = _loader("pt", pt_vol, prefetch=2, window_steps=2)
    try:
        for s in range(2):
            _equal_batches(next(ld), ref.make_batch(s))
        ld.seek(9)
        _equal_batches(next(ld), ref.make_batch(9))
        assert ld.state.step == 10
        resumed = _loader("pt", pt_vol, start_step=10)
        _equal_batches(next(resumed), ref.make_batch(10))
        state = pt_pipeline.LoaderState.from_json(ld.state.to_json())
        assert state.step == 10
    finally:
        ld.close()


def test_rank_slices_match_reference(worlds):
    (_, ref_vol), (_, pt_vol) = worlds
    rows = []
    for r in range(4):
        a = _loader("ref", ref_vol, dp_rank=r, dp_size=4)
        b = _loader("pt", pt_vol, dp_rank=r, dp_size=4)
        assert np.array_equal(a.rows_for_step(3), b.rows_for_step(3))
        _equal_batches(a.make_batch(3), b.make_batch(3))
        rows.append(b.rows_for_step(3))
    assert len(np.unique(np.concatenate(rows))) == 16
    assert not np.array_equal(b.rows_for_step(0),
                              b.rows_for_step(b.steps_per_epoch))


@pytest.mark.parametrize("packed", [False, True])
def test_hedged_reads_match_reference(worlds, packed):
    (ref_store, ref_vol), (pt_store, pt_vol) = worlds
    counts = []
    for pkg, store, vol in (("ref", ref_store, ref_vol),
                            ("pt", pt_store, pt_vol)):
        before = _counters(store.fabric.snapshot())
        b = _loader(pkg, vol, packed=packed,
                    hedge_timeout_s=5.0).make_batch(1)
        after = _counters(store.fabric.snapshot())
        counts.append(({k: after[k] - before[k] for k in after}, b))
    _equal_batches(counts[0][1], counts[1][1])
    assert counts[0][0] == counts[1][0]


def test_loader_rejects_bad_options(worlds):
    _, (_, vol) = worlds
    with pytest.raises(ValueError, match="dp_size"):
        _loader("pt", vol, global_batch=10, dp_size=4)
    with pytest.raises(ValueError, match="prefetch"):
        _loader("pt", vol, window_steps=2, prefetch=0)
    with pytest.raises(ValueError, match="hedge"):
        _loader("pt", vol, window_steps=2, prefetch=1, hedge_timeout_s=1.0)


def test_device_stream_on_cpu_matches_make_batch(worlds):
    _, (_, vol) = worlds
    win = _loader("pt", vol, packed=True, prefetch=2, window_steps=2)
    ref = _loader("pt", vol, packed=True)
    try:
        stream = fi.device_stream(win, lookahead=1, device="cpu")
        for s in range(4):
            words = next(stream)
            assert words.dtype == torch.int32 and words.device.type == "cpu"
            want = ref.make_batch(s)["tokens_packed"]
            assert np.array_equal(words.numpy().view(np.uint32), want)
    finally:
        win.close()


def test_device_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is used")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(fi.device_stream(iter([])))


@pytest.mark.gpu
def test_device_stream_on_card_matches_make_batch(worlds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import bitunpack as bu
    _, (_, vol) = worlds
    win = _loader("pt", vol, packed=True, prefetch=2, window_steps=2)
    plain = _loader("pt", vol)
    try:
        stream = fi.device_stream(win, lookahead=1, device="cuda:0")
        for s in range(4):
            before = bu.launches
            fb = fi.fused_batch(next(stream))
            assert bu.launches == before + 1
            want = plain.make_batch(s)
            assert np.array_equal(fb["tokens"].cpu().numpy(), want["tokens"])
            assert np.array_equal(fb["labels"].cpu().numpy(), want["labels"])
    finally:
        win.close()
