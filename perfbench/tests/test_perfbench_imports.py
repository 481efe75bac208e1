"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level names (``repro_torch`` begins with
``repro``), and the plain reference and the FLOPs arithmetic import
nothing of the program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)
PLAIN = sorted([*(PB / "reference").rglob("*.py"), PB / "flops.py",
                PB / "weights.py"])


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: str(p.relative_to(PB)))
def test_reference_and_flops_import_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "reproducible",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.store", "jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.store"]


def test_a_run_loads_no_jax_module(tmp_path):
    """Both smoke cells driven in a fresh interpreter, which then lists
    every module it holds."""
    code = (
        "import sys, json, torch; from pathlib import Path\n"
        "torch.set_num_threads(1)\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
        "from perfbench import smoke, harness\n"
        f"root = smoke.make_copy(Path({str(tmp_path)!r}))\n"
        "lines = [smoke.run(root, c) for c in (smoke.TRAIN_CELL, smoke.SERVE_CELL)]\n"
        "print(json.dumps([[l['correct'] for l in lines], sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, modules = json.loads(out.stdout.splitlines()[-1])
    assert correct == [True, True]
    assert "repro_torch" in modules
    assert harness.forbidden_modules(modules) == []
