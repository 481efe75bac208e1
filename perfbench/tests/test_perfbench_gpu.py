"""On the card: each cell of BENCHMARK.json through the real command at a
short window, its last line parsed and ``correct``.  Run there with
``python -m pytest -m gpu perfbench/tests``; without a card each test
skips."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(wl):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", wl, "--seed",
         "2147483693", "--seconds", "5", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
