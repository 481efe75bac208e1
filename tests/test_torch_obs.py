"""The port's span and counter recorder (``repro_torch.obs``) and the
spans and counters placed in the Trainer, the loader, the serve engine
and the model: when it records, what a record holds, and that each
step, call and routing decision is recorded once."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from _threads import few_torch_threads  # noqa: F401

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import GlobalVOL, make_store
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models import moe
from repro_torch.models.archs import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as pt_opt
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def empty_recorder():
    obs.clear()
    yield
    obs.clear()


class FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on a machine without a card:
    ``record`` notes the host clock in milliseconds."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        self.at = time.perf_counter() * 1e3

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return torch.device("cuda", 0)


# ------------------------------------------------------------ on and off
def test_off_records_nothing_and_makes_no_event(fake_cuda):
    assert not obs.on()
    with obs.span("a", device=fake_cuda, x=1) as got:
        obs.instant("b")
        obs.count("c", 3)
    assert got is None
    assert obs.span("a") is obs.span("b")     # one shared null context
    with obs.timed("d") as t:
        pass
    assert t.seconds >= 0
    assert obs.spans() == [] and obs.counts() == []
    assert FakeEvent.made == 0


def test_on_while_the_profiler_records_and_inside_recording():
    from torch.autograd import profiler as autograd_profiler

    assert not obs.on()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        # the flag the recorder reads, as this torch sets it
        assert autograd_profiler._is_profiler_enabled is True
        assert obs.on()
        with obs.span("profiled"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    assert not obs.on()
    with obs.span("after"):
        pass
    with obs.recording():
        assert obs.on()
        with obs.recording():
            pass
        assert obs.on()
        with obs.quiet():
            assert not obs.on()
            with obs.span("quiet"):
                obs.count("quiet", 1)
        with obs.span("recorded"):
            pass
    assert not obs.on()
    assert [s.name for s in obs.spans()] == ["profiled", "recorded"]
    assert obs.counts() == []


def test_a_span_lies_between_the_clock_reads_around_it():
    with obs.recording():
        a = time.perf_counter()
        with obs.span("s", k="v"):
            time.sleep(0.002)
        b = time.perf_counter()
        obs.instant("i")
        c = time.perf_counter()
    s, i = obs.spans()
    assert a <= s.start_s <= s.end_s <= b
    assert s.seconds >= 0.002 and s.attrs == {"k": "v"}
    assert b <= i.start_s == i.end_s <= c
    assert obs.spans((a, b)) == [s] and obs.spans((b, c)) == [i]
    assert obs.spans((a + 1, c + 1)) == []


def test_device_intervals_are_resolved_when_read(fake_cuda):
    with obs.recording():
        with obs.span("dev", device=fake_cuda):
            time.sleep(0.002)
        with obs.span("host", device=torch.device("cpu")):
            pass
    assert FakeEvent.made == 2
    raw = list(obs._records)
    assert raw[0].events is not None and raw[0].device_ms is None
    dev, host = obs.spans()
    assert dev.events is None and dev.device_ms >= 2.0
    assert host.device_ms is None


def test_counts_keep_device_values_until_read():
    with obs.recording(), obs.span("outer"):
        obs.count("n", 2)
        obs.count("n", torch.tensor(5))
    (outer,) = obs.spans()
    a, b = obs.counts()
    assert isinstance(b.raw, torch.Tensor)
    assert (a.value, b.value) == (2.0, 5.0)
    assert a.parent == b.parent == outer.id


def test_parents_nest_per_thread():
    ids = {}

    def worker():
        with obs.span("w.root"):
            with obs.span("w.child"):
                ids["w"] = threading.get_ident()

    with obs.recording():
        with obs.span("m.root"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with obs.span("m.child"):
                obs.instant("m.leaf")
    by = {s.name: s for s in obs.spans()}
    main = threading.get_ident()
    assert by["m.root"].parent is None and by["w.root"].parent is None
    assert by["m.child"].parent == by["m.root"].id
    assert by["m.leaf"].parent == by["m.child"].id
    assert by["w.child"].parent == by["w.root"].id
    assert {by[n].thread for n in ("m.root", "m.child", "m.leaf")} == {main}
    assert {by[n].thread for n in ("w.root", "w.child")} == {ids["w"]}


# ------------------------------------------------------------ the program
@pytest.fixture(scope="module")
def world():
    store = make_store(4, replicas=2)
    vol = GlobalVOL(store)
    build_corpus(vol, CorpusSpec(n_seqs=64, seq_len=64, vocab_size=256,
                                 seed=2))
    yield store, vol
    store.close()


def test_the_loader_fetches_on_its_producer_thread(world):
    _, vol = world
    with obs.recording():
        loader = ObjectDataLoader(vol, "corpus", global_batch=4, seed=1,
                                  packed=True, prefetch=2)
        try:
            for _ in range(3):
                next(loader)
        finally:
            loader.close()
    spans = obs.spans()
    main = threading.get_ident()
    waits = [s for s in spans if s.name == "loader.wait"]
    fetches = [s for s in spans if s.name == "loader.fetch"]
    assert len(waits) == 3 and {s.thread for s in waits} == {main}
    assert len(fetches) >= 3
    assert all(s.thread != main and s.parent is None for s in fetches)
    assert [s.attrs["step"] for s in fetches[:3]] == [0, 1, 2]


def _ancestor(spans: dict, rec, name: str):
    at = rec.parent
    while at is not None and spans[at].name != name:
        at = spans[at].parent
    return at


def test_trainer_steps_and_moe_counts_under_full_remat(world, monkeypatch):
    """Two packed steps of a smoke MoE model, every block recomputed in
    the backward: one ``train.step`` a step with its parts in order,
    ``wall_s`` its clock reads, and one ``moe.routed`` / ``moe.dropped``
    a MoE layer a step, equal to the routing that the forward did."""
    store, vol = world
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))           # drops at this size
    model = build_model(cfg, remat="full", device="cpu")
    model.init(torch.Generator().manual_seed(0))
    B, S = 8, 64
    loader = ObjectDataLoader(vol, "corpus", global_batch=B, seed=3,
                              packed=True, prefetch=2)
    tr = Trainer(model, loader, store,
                 opt=pt_opt.OptConfig(lr=1e-3, warmup_steps=1,
                                      total_steps=10),
                 cfg=TrainerConfig(total_steps=2, ckpt_every=1 << 30,
                                   log_every=100, packed_ingest=True),
                 log=lambda s: None)
    routings = []                   # (kept under recording, idx)
    top_k = moe._top_k

    def spy(probs, k):
        vals, idx = top_k(probs, k)
        routings.append((obs.on(), idx.clone()))
        return vals, idx
    monkeypatch.setattr(moe, "_top_k", spy)
    with obs.recording():
        tr.run()
    loader.close()

    spans = obs.spans()
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.attrs["step"] for s in steps] == [1, 2]
    assert [h["wall_s"] for h in tr.history] == [s.seconds for s in steps]
    for st in steps:
        kids = sorted((s for s in spans if s.parent == st.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["train.next", "train.h2d",
                                          "train.launch", "train.sync"]
        launch = kids[2]
        parts = sorted((s for s in spans if s.parent == launch.id),
                       key=lambda s: s.start_ns)
        assert [s.name for s in parts] == ["train.unpack", "train.forward",
                                           "train.backward",
                                           "train.optimizer"]
        assert [s.name for s in spans if s.parent == kids[0].id] == \
            ["loader.wait"]
    assert not any(s.name == "train.ckpt" for s in spans)

    n_moe = cfg.n_layers - cfg.moe.first_dense
    T, k, E = B * S, cfg.moe.top_k, cfg.moe.n_routed
    C = moe._capacity(T, cfg)
    # the forward's routing is kept; the backward's recomputation of the
    # same blocks routes again under quiet()
    assert [on for on, _ in routings] == ([True] * n_moe
                                          + [False] * n_moe) * 2
    dropped = []
    for on, idx in routings:
        if on:
            per_expert = torch.bincount(idx.reshape(-1), minlength=E)
            dropped.append(T * k - int(per_expert.clamp(max=C).sum()))
    assert sum(dropped) > 0
    counts = obs.counts()
    for st in steps:
        mine = [c for c in counts
                if _ancestor(by_id, c, "train.step") == st.id]
        routed = [c.value for c in mine if c.name == "moe.routed"]
        assert routed == [float(T * k)] * n_moe
        ffn = [by_id[c.parent] for c in mine if c.name == "moe.routed"]
        assert [s.name for s in ffn] == ["model.ffn"] * n_moe
        assert [s.attrs["layer"] for s in ffn] == list(
            range(cfg.moe.first_dense, cfg.n_layers))
        assert [c.value for c in mine if c.name == "alloc.retries"] == [0.0]
    got = [c.value for c in counts if c.name == "moe.dropped"]
    assert got == [float(d) for d in dropped]
    kept = [T * k - d for d in got]
    assert [a + b for a, b in zip(kept, got)] == \
        [c.value for c in counts if c.name == "moe.routed"]
    # the forward's layers: attention and FFN a block, the head once
    fwd = [s for s in spans if s.name == "train.forward"]
    for f in fwd:
        inner = [s for s in spans
                 if s.name.startswith("model.") and
                 _ancestor(by_id, s, "train.forward") == f.id]
        assert sorted((s.name, s.attrs["layer"]) for s in inner) == sorted(
            [("model.attn", i) for i in range(cfg.n_layers)]
            + [("model.ffn", i) for i in range(cfg.n_layers)]
            + [("model.head", cfg.n_layers)])


@pytest.mark.parametrize("n", [1, 4])
def test_generate_records_one_call(n):
    cfg = get_config("starcoder2_7b", smoke=True)
    model = build_model(cfg, remat="none", device="cpu")
    model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, max_seq=32)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(1, cfg.vocab_size, 8).astype(np.int32),
                    max_new=n) for _ in range(3)]
    with obs.recording():
        comps = eng.generate(reqs)
    assert [len(c.tokens) for c in comps] == [n] * 3
    spans = obs.spans()
    names = [s.name for s in spans]
    (gen,) = [s for s in spans if s.name == "serve.generate"]
    (first,) = [s for s in spans if s.name == "serve.first_token"]
    (prefill,) = [s for s in spans if s.name == "serve.prefill"]
    assert names.count("serve.decode.launch") == n - 1
    assert names.count("serve.decode") == n - 1
    assert first.parent == gen.id and prefill.parent == gen.id
    assert prefill.end_s <= first.start_s <= gen.end_s
    assert gen.attrs["requests"] == 3
    assert {s.attrs["batch"] for s in spans if s.name.startswith("serve.")
            and s.name != "serve.decode.launch"} == {gen.attrs["batch"]}
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "serve.decode.launch":
            assert by_id[s.parent].name == "serve.decode"
        if s.name == "serve.token_sync" or s.name == "serve.bookkeeping":
            assert by_id[s.parent].name in ("serve.generate", "serve.decode")
    attn = [s for s in spans if s.name == "model.attn"]
    assert len(attn) == cfg.n_layers * n
    assert sorted(s.attrs["layer"] for s in attn
                  if s.parent == prefill.id) == list(range(cfg.n_layers))
    # the same tokens without recording
    again = eng.generate(reqs)
    assert all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(comps, again))
