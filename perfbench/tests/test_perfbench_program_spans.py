"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.obs``): each reader on hand-made records, on an empty
recorder and without the program's recorder at all (the parent of the
change that brought it), and both smoke cells traced on the CPU with the
recorder on."""

import itertools
import sys
import threading

import pytest

from perfbench import harness, smoke
from repro_torch import obs

REPO = smoke.REPO
NEW = ["launch_ms.train", "optimizer_device_ms.train",
       "moe_drop_share.train", "alloc_retries.train", "loader_wait_ms.train",
       "loader_fetch_ms.train", "decode_launch_ms.serve",
       "first_token_ms.serve", "attn_device_ms.prefill"]
DEVICE = {"optimizer_device_ms.train", "attn_device_ms.prefill"}
IDS = itertools.count(1 << 40)


class Run:
    window = (10.0, 20.0)


@pytest.fixture(autouse=True)
def empty_recorder():
    obs.clear()
    yield
    obs.clear()


def reader(name):
    return harness.load_reader(REPO, name)


def span(name, start, end, parent=None, device_ms=None):
    rec = obs.Span(name, next(IDS), parent, threading.get_ident(), {},
                   int(start * 1e9), int(end * 1e9), device_ms)
    obs._records.append(rec)
    return rec


def count(name, at, value, parent=None):
    obs._records.append(obs.Count(name, int(at * 1e9), parent,
                                  threading.get_ident(), value))


@pytest.mark.parametrize("name", NEW)
def test_none_without_records_or_without_the_recorder(name, monkeypatch):
    assert reader(name)(Run()) is None
    monkeypatch.delitem(sys.modules, "repro_torch.obs")
    assert reader(name)(Run()) is None


def train_records():
    """Two steps in the window and one before it, whose records must
    not count."""
    for off, inside in ((5.0, False), (11.0, True), (13.0, True)):
        st = span("train.step", off, off + 1.0)
        nxt = span("train.next", off, off + 0.1, st.id)
        span("loader.wait", off, off + 0.004 if inside else off + 0.1,
             nxt.id)
        la = span("train.launch", off + 0.1, off + 0.3 if inside
                  else off + 0.9, st.id)
        span("train.optimizer", off + 0.2, off + 0.25, la.id,
             device_ms=300.0 if inside else 900.0)
        ffn = span("model.ffn", off + 0.12, off + 0.13, la.id)
        count("moe.routed", off + 0.125, 100, ffn.id)
        count("moe.dropped", off + 0.125, 5 if inside else 90, ffn.id)
        count("alloc.retries", off + 0.9, 1 if inside else 7, st.id)
        span("loader.fetch", off + 0.5, off + (0.52 if inside else 0.9))


@pytest.mark.parametrize("name, want", [
    ("launch_ms.train", 200.0), ("optimizer_device_ms.train", 300.0),
    ("moe_drop_share.train", 5.0), ("alloc_retries.train", 1.0),
    ("loader_wait_ms.train", 4.0), ("loader_fetch_ms.train", 20.0)])
def test_train_readers_on_hand_made_records(name, want):
    train_records()
    assert reader(name)(Run()) == pytest.approx(want)


def serve_records():
    """Two calls in the window, one outside it."""
    for off, inside in ((2.0, False), (11.0, True), (15.0, True)):
        gen = span("serve.generate", off, off + 3.0)
        pre = span("serve.prefill", off + 0.01, off + 1.0, gen.id,
                   device_ms=900.0)
        for layer in range(3):
            span("model.attn", off + 0.1 * layer, off + 0.1 * layer + 0.01,
                 pre.id, device_ms=100.0 if inside else 1.0)
        span("model.head", off + 0.9, off + 0.95, pre.id, device_ms=50.0)
        span("serve.first_token", off + (1.5 if inside else 0.2),
             off + (1.5 if inside else 0.2), gen.id)
        for step in range(2):
            dec = span("serve.decode", off + 2 + step * 0.2,
                       off + 2.1 + step * 0.2, gen.id)
            la = span("serve.decode.launch", off + 2 + step * 0.2,
                      off + 2.05 + step * 0.2 if inside
                      else off + 2.1 + step * 0.2, dec.id)
            span("model.attn", off + 2.01 + step * 0.2,
                 off + 2.02 + step * 0.2, la.id)


@pytest.mark.parametrize("name, want", [
    ("decode_launch_ms.serve", 50.0), ("first_token_ms.serve", 1500.0),
    ("attn_device_ms.prefill", 300.0)])
def test_serve_readers_on_hand_made_records(name, want):
    serve_records()
    assert reader(name)(Run()) == pytest.approx(want)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return smoke.make_copy(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell, suffix", [
    (smoke.TRAIN_CELL, (".train",)),
    (smoke.SERVE_CELL, (".serve", ".prefill"))])
def test_smoke_cells_read_every_program_metric(copy, cell, suffix):
    """Traced on the CPU with the recorder on (no profiler runs there):
    every new metric of the cell but the device intervals is read."""
    with obs.recording():
        line = smoke.run(copy, cell, seed=41, seconds=2.0, trace=True)
    assert line["correct"], line["checks"]
    want = {n for n in NEW if n.endswith(suffix)} - DEVICE
    assert want <= set(line["metrics"])
    assert not DEVICE & set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0


def test_untraced_and_unrecorded_runs_read_none_of_them(copy):
    line = smoke.run(copy, smoke.SERVE_CELL, seed=42, trace=True)
    assert not set(NEW) & set(line["metrics"])
