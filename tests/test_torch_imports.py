"""The port stands alone: it imports neither JAX nor the reference
package, and its default decode runs on the card or raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import format as pt_fmt

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.core.store" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_import_of_jax_or_reference_in_source(where):
    files = (sorted(PKG.rglob("*.py")) if where == "package"
             else [ROOT / "chip_smoke.py"])
    assert files and all(f.exists() for f in files)
    bad = [(str(f.relative_to(ROOT)), line, mod)
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert bad == []


def test_default_backend_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend launches")
    assert pt_fmt.get_bitunpack_backend() == "device"
    table = {"a": np.arange(100, dtype=np.int32)}
    blob = pt_fmt.encode_block(table, codecs=pt_fmt.auto_codecs(table))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_fmt.decode_block(blob)
    # a column with no bitpack codec needs no card
    raw = pt_fmt.encode_block(table)
    assert np.array_equal(pt_fmt.decode_block(raw)["a"], table["a"])
