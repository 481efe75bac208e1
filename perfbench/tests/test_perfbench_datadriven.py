"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries only: in a copy of ``perfbench/`` with new files (no
file of it edited), the new cell runs through the harness's functions
at smoke size on the CPU and reports the new metric.  The real command
refuses to run without a card."""

import filecmp
import json
import os
import subprocess
import sys

import pytest

from perfbench import smoke

REPO = smoke.REPO

METRIC = '''"""Steps the window ran."""


def read(run):
    return float(len(run.steps)) if run.steps else None
'''


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    root = smoke.make_copy(tmp_path_factory.mktemp("pb"))
    pb = root / "perfbench"
    cfg = dict(smoke.DSV2, name="dsv2_smoke_two",
               num_hidden_layers=2, port=dict(
                   smoke.DSV2["port"],
                   replace={"n_layers": 2, "moe": {"capacity_factor": 1.25}}))
    (pb / "configs" / "dsv2_smoke_two.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "smoke.train.short.json").write_text(json.dumps(
        dict(smoke.TRAIN, seq_len=32, batch=2, corpus_seqs=16)))
    (pb / "metrics" / "window_steps.train.py").write_text(METRIC)
    (pb / "cells" / "dsv2two.train.short.json").write_text(
        (pb / "cells" / f"{smoke.TRAIN_CELL}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dsv2_smoke_two", "source": "smoke",
                             "file": "perfbench/configs/dsv2_smoke_two.json",
                             "reduced": [], "why": "smoke"})
    bench["workloads"].append({"name": "dsv2two.train.short",
                               "config": "dsv2_smoke_two",
                               "traffic": "smoke.train.short", "chips": 1,
                               "why": "smoke"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "mfu.train",
                         "ingest_wait_ms.train"):
            m["workloads"].append("dsv2two.train.short")
    bench["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["dsv2two.train.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_no_file_of_the_benchmark_is_edited(added):
    for sub in ("configs", "traffic", "metrics", "cells", "kinds",
                "reference"):
        cmp = filecmp.dircmp(REPO / "perfbench" / sub,
                             added / "perfbench" / sub,
                             ignore=["__pycache__"])
        assert not cmp.diff_files and not cmp.left_only


@pytest.mark.parametrize("trace", [False, True])
def test_the_added_cell_runs(added, trace):
    line = smoke.run(added, "dsv2two.train.short", seed=31, trace=trace)
    assert line["correct"], line["checks"]
    if trace:
        assert line["metrics"]["window_steps.train"]["value"] >= 1
        assert set(line["metrics"]) == {"window_steps.train", "mfu.train",
                                        "ingest_wait_ms.train"}
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_the_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "dsv2lite.train.packed4k", "--seed", "2147483659", "--seconds",
         "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/."""
    import shutil
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "starcoder2.serve.repo_completion", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
