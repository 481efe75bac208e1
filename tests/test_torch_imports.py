"""The port stands alone: it imports neither JAX nor the reference
package, and its default decode runs on the card or raises."""

import ast
import importlib
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
    assert {"repro_torch.core.store", "repro_torch.core.pushdown_torch",
            "repro_torch.kernels.ops", "repro_torch.kernels.filter_agg",
            "repro_torch.kernels.block_agg",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression",
            "repro_torch.launch.mesh", "repro_torch.data.corpus",
            "repro_torch.data.pipeline",
            "repro_torch.data.fused_ingest", "repro_torch.core.faults",
            "repro_torch.core.session", "repro_torch.core.skyhook",
            "repro_torch.core.maintenance",
            "repro_torch.distributed.elastic", "repro_torch.pytree",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.serve", "repro_torch.serve.kvcache",
            "repro_torch.configs", "repro_torch.configs.base",
            *(f"repro_torch.configs.{a}" for a in (
                "deepseek_67b", "deepseek_v2_lite_16b", "granite_20b",
                "grok1_314b", "musicgen_large", "pixtral_12b", "rwkv6_3b",
                "starcoder2_7b", "yi_9b", "zamba2_2p7b")),
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.inputs",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.recurrent",
            "repro_torch.models.transformer", "repro_torch.models.archs",
            "repro_torch.serve.engine", "repro_torch.serve.steps",
            "repro_torch.launch", "repro_torch.launch.serve",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.steps", "repro_torch.train.trainer",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.op_analysis", "repro_torch.analysis",
            "repro_torch.analysis.base", "repro_torch.analysis.invariants",
            "repro_torch.analysis.registry", "repro_torch.analysis.cli",
            "repro_torch.analysis.lockcheck",
            "repro_torch.analysis.pytest_plugin"} <= set(mods)
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


@pytest.mark.parametrize("pkg", ["core", "checkpoint", "configs"])
def test_exports_match_the_reference(pkg):
    """Every public name the reference package exports, the port
    exports too (``repro.checkpoint`` and ``repro.configs`` need JAX, so
    they are read, not imported)."""
    import inspect

    port = importlib.import_module(f"repro_torch.{pkg}")
    if pkg == "core":
        import repro.core as ref
        names = {n for n in dir(ref) if not n.startswith("_")
                 and not inspect.ismodule(getattr(ref, n))}
    else:
        init = ROOT / "src" / "repro" / pkg / "__init__.py"
        names = {a.asname or a.name
                 for node in ast.walk(ast.parse(init.read_text()))
                 if isinstance(node, ast.ImportFrom) for a in node.names}
    assert names and names <= set(dir(port))


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


EXAMPLES = ("quickstart_torch.py", "serve_pushdown_torch.py",
            "train_e2e_torch.py")


@pytest.mark.parametrize("where", ["package", "chip_smoke", "examples"])
def test_no_import_of_jax_or_reference_in_source(where):
    files = {"package": sorted(PKG.rglob("*.py")),
             "chip_smoke": [ROOT / "chip_smoke.py"],
             "examples": [ROOT / "examples" / f for f in EXAMPLES]}[where]
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
