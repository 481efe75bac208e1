"""``perfbench.trace.reduce`` on hand-made device events."""

import pytest

from perfbench import trace


def test_busy_is_the_union_and_gaps_are_named_by_the_open_span():
    ms = 1_000_000
    # device clock = host clock + 5 ms
    events = [(5 * ms + 1 * ms, 5 * ms + 3 * ms, "gemm"),
              (5 * ms + 2 * ms, 5 * ms + 4 * ms, "copy"),      # overlaps
              (5 * ms + 7 * ms, 5 * ms + 8 * ms, "gemm")]
    spans = [("engine.generate", 0.0, 0.010),
             ("engine.decode", 0.0045, 0.0065)]
    out = trace.reduce(events, (0.0, 0.010), 5 * ms, spans)
    assert out["window_s"] == pytest.approx(0.010)
    assert out["busy_s"] == pytest.approx(0.004)
    assert dict(map(tuple, out["device_ops"])) == pytest.approx(
        {"gemm": 0.003, "copy": 0.002})
    idle = dict(map(tuple, out["idle_gaps"]))
    # gaps: 0-1 ms, 4-7 ms (midpoint 5.5 ms, in decode), 8-10 ms
    assert idle == pytest.approx({"engine.generate": 0.003,
                                  "engine.decode": 0.003})


def test_without_a_marker_the_gaps_are_unaligned():
    out = trace.reduce([(10, 20, "k"), (30, 40, "k")], (0.0, 1.0), None, [])
    assert out["window_s"] == pytest.approx(30e-9)
    assert out["busy_s"] == pytest.approx(20e-9)
    assert out["idle_gaps"] == [["unaligned", pytest.approx(10e-9)]]


def test_lists_hold_at_most_ten_entries():
    events = [(i * 10, i * 10 + 5, f"k{i}") for i in range(30)]
    out = trace.reduce(events, (0.0, 1.0), None, [])
    assert len(out["device_ops"]) == 10
