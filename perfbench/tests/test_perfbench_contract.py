"""``BENCHMARK.json`` against the rules the benchmark is held to: its
keys, names, units, bounds and window, and every file a cell, a
configuration or a metric needs."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH = re.compile(r"(_dim|_rank|_size)$|^hidden|intermediate|latent|"
                   r"state|projection|expan|experts_per_tok")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert BENCH["command"] == ["python3", "perfbench/run.py"]


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"],
                                   *METRICS], ids=lambda e: e["name"])
def test_entry_keys_and_names(entry):
    keys = set(entry)
    if entry in BENCH["configs"]:
        assert keys == {"name", "source", "file", "reduced", "why"}
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in entry["reduced"])
    elif entry in BENCH["workloads"]:
        assert keys == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
        assert len(entry["why"]) <= 200
    else:
        base = {"name", "unit", "better", "source"}
        base |= {"bound"} if entry in BENCH["end_to_end"] else {
            "layer", "moves"}
        assert keys - {"workloads"} == base
        assert UNIT.match(entry["unit"]) and entry["better"] in (
            "lower", "higher")
    assert NAME.match(entry["name"])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(wl):
    cell = harness.find_cell(REPO, wl["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert (REPO / "perfbench" / "kinds"
            / f"{cell.traffic['kind']}.py").exists()
    assert cell.limits


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(harness.load_reader(REPO, m["name"]))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_their_cuts(c):
    cfg = json.loads((REPO / c["file"]).read_text())
    assert c["file"].startswith("perfbench/")
    assert cfg["source"] == c["source"]
    assert sorted(c["reduced"]) == sorted(cfg.get("published", {}))
    assert set(cfg.get("why", {})) == set(cfg.get("published", {}))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_departures_are_stated_apart_from_the_cuts(c):
    """A key the program runs otherwise keeps its published value at the
    top level and is no cut: ``reduced`` names depth alone."""
    cfg = json.loads((REPO / c["file"]).read_text())
    assert set(c["reduced"]) <= {"num_hidden_layers"}
    for key, d in cfg.get("departures", {}).items():
        assert key not in c["reduced"] and key in cfg
        assert d["as_run"] != cfg[key] and d["why"]


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_served_traffic_stays_inside_the_sliding_window(wl):
    """The program attends to the whole prefix: a configuration's window
    may not bind on any padded prompt with its completion."""
    from perfbench.kinds import serve_closed

    cell = harness.find_cell(REPO, wl["name"])
    window = cell.config.get("sliding_window")
    if cell.traffic["kind"] != "serve_closed" or not window:
        return
    assert serve_closed.max_seq(cell.traffic) <= window
