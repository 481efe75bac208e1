"""The port's examples (``examples/*_torch.py``) run through their
``main(argv)`` on the CPU at their smallest settings, their own
assertions holding; without a card their default device raises."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch
from _threads import few_torch_threads  # noqa: F401

from repro_torch.core import format as pt_fmt
from repro_torch.kernels import bitunpack as bu

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart_torch", "serve_pushdown_torch", "train_e2e_torch")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def backend_restored():
    """Each example selects its decode backend and restores the caller's."""
    mode = pt_fmt.get_bitunpack_backend()
    yield
    assert pt_fmt.get_bitunpack_backend() == mode


def test_quickstart_on_cpu():
    out = _example("quickstart_torch").main(["--device", "cpu"])
    assert out["device"] == "cpu"
    assert out["registry_ops"] == 13
    assert out["loss_last"] < out["loss_first"]


def test_serve_pushdown_on_cpu():
    out = _example("serve_pushdown_torch").main(["--device", "cpu"])
    assert out["requests"] == 8 and out["tokens"] == 8 * 12
    assert out["kv_objects"] > 0 and out["tokens_per_s"] > 0
    assert out["slow"] > 0


def test_train_e2e_tiny_on_cpu(tmp_path):
    path = tmp_path / "e2e.json"
    out = _example("train_e2e_torch").main(
        ["--preset", "tiny", "--steps", "10", "--device", "cpu",
         "--out", str(path)])
    saved = json.loads(path.read_text())
    assert saved["steps_done"] == 10 and saved["loss_last"] == out["loss_last"]
    assert out["killed"]["step"] == 5 and out["killed"]["objects_lost"] == 0
    assert out["checkpoints"] > 0
    assert out["loss_last"] < out["loss_first"]
    # the reference's module switches in force, named in the record
    assert saved["switches"] == {"HEAD_TP": "padded", "XENT_MM": "mixed"}


def test_train_e2e_presets_keep_the_references_widths():
    """The presets and ``make_cfg``'s float32 params are the reference's
    (``examples/train_e2e.py``, read, not imported: it needs JAX)."""
    import ast
    src = (EXAMPLES / "train_e2e.py").read_text()
    tree = ast.parse(src)
    table = next(node.value for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "PRESETS")
    ref = {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                 for kw in v.keywords}     # dict(...)
           for k, v in zip(table.keys, table.values)}
    mod = _example("train_e2e_torch")
    assert mod.PRESETS == ref
    cfg = mod.make_cfg(mod.PRESETS["100m"])
    assert cfg.param_dtype == cfg.compute_dtype == torch.float32
    assert (cfg.n_layers, cfg.d_model) == (12, 768)


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = ["--out", str(tmp_path / "o.json")] \
        if name == "train_e2e_torch" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_example_on_card_launches_the_kernel(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    argv = ["--preset", "tiny", "--steps", "10", "--out",
            str(tmp_path / "o.json")] if name == "train_e2e_torch" else []
    before = bu.launches
    _example(name).main(argv)
    assert bu.launches > before
