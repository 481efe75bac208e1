"""Smoke-size cells for the CPU tests: a copy of ``perfbench/`` in a
temporary directory with two more configurations (the program's smoke
sizes of the two configured models, float32), two more traffic mixes,
their cell files and a ``BENCHMARK.json`` that names them, all added as new
files: nothing of the copy is edited.  ``run`` then drives a cell
through the harness's functions on the CPU (``run.py`` itself refuses
to run without a card).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

from perfbench import harness

REPO = Path(__file__).resolve().parent.parent

DSV2 = {
    "name": "dsv2_smoke", "source": "the program's deepseek_v2_lite_16b smoke sizes",
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 160, "rope_theta": 10000, "rms_norm_eps": 1e-05,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 8, "n_shared_experts": 1,
    "num_experts_per_tok": 2, "moe_intermediate_size": 32,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "torch_dtype": "float32",
    "model": {"attention": "mla", "norm": "rmsnorm", "mlp": "silu_gated"},
    "assumed": {"moe_capacity_factor": 1.25, "aux_loss_coef": 0.01,
                "router_z_loss_coef": 0.001, "xent_z_loss_coef": 0.0001},
    "port": {"arch": "deepseek_v2_lite_16b", "smoke": True, "remat": "full",
             "replace": {"moe": {"capacity_factor": 1.25}},
             "keys": {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
                      "kv_lora_rank": "mla.kv_lora_rank",
                      "n_routed_experts": "moe.n_routed",
                      "num_experts_per_tok": "moe.top_k",
                      "torch_dtype": "param_dtype"}},
}

SC2 = {
    "name": "sc2_smoke", "source": "the program's starcoder2_7b smoke sizes",
    "vocab_size": 256, "hidden_size": 96, "num_hidden_layers": 2,
    "num_attention_heads": 6, "num_key_value_heads": 2,
    "intermediate_size": 256, "rope_theta": 10000, "norm_epsilon": 1e-05,
    "head_dim": 16, "torch_dtype": "float32",
    "model": {"attention": "gqa", "norm": "layernorm", "mlp": "gelu_tanh"},
    "assumed": {},
    "port": {"arch": "starcoder2_7b", "smoke": True, "remat": "none",
             "keys": {"hidden_size": "d_model", "num_attention_heads": "n_heads",
                      "num_key_value_heads": "n_kv_heads",
                      "torch_dtype": "param_dtype"}},
}

SMOKE_OPT = {"lr": 0.001, "warmup_steps": 2, "total_steps": 24,
             "betas": [0.9, 0.95], "eps": 1e-08, "weight_decay": 0.1,
             "clip_norm": 1.0, "min_lr_frac": 0.1}

TRAIN = {"kind": "train_packed", "corpus_seqs": 32, "seq_len": 64,
         "batch": 4, "osds": 4, "replicas": 2, "object_bytes": 4096,
         "max_object_bytes": 65536, "prefetch": 2, "check_steps": 3,
         "trace_steps": 2}

SERVE = {"kind": "serve_closed", "clients": 3,
         "prompt": {"min": 8, "max": 40}, "max_new": {"min": 2, "max": 6},
         "pad_multiple": 8, "check_requests": 4, "trace_batches": 1}

TRAIN_CELL, SERVE_CELL = "dsv2_smoke.train", "sc2_smoke.serve"


def make_copy(dest: Path) -> Path:
    """``perfbench/`` and ``BENCHMARK.json`` copied under ``dest``, the
    smoke cells added as new files; returns the copy's root."""
    root = dest / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "perfbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (DSV2, SC2):
        (pb / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"perfbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "smoke"})
    (pb / "traffic" / "smoke.train.json").write_text(json.dumps(TRAIN))
    (pb / "traffic" / "smoke.serve.json").write_text(json.dumps(SERVE))
    (pb / "cells" / f"{TRAIN_CELL}.json").write_text(json.dumps(
        dict(json.loads((pb / "cells" / "dsv2lite.train.packed4k.json")
                        .read_text()), optimizer=SMOKE_OPT)))
    (pb / "cells" / f"{SERVE_CELL}.json").write_text(
        (pb / "cells" / "starcoder2.serve.repo_completion.json").read_text())
    bench["workloads"] += [
        {"name": TRAIN_CELL, "config": "dsv2_smoke", "traffic": "smoke.train",
         "chips": 1, "why": "smoke"},
        {"name": SERVE_CELL, "config": "sc2_smoke", "traffic": "smoke.serve",
         "chips": 1, "why": "smoke"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [TRAIN_CELL if ".train" in m["name"]
                               or m["name"].startswith("train")
                               else SERVE_CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "src").symlink_to(REPO / "src")
    return root


def run(root: Path, workload: str, seed: int = 5, seconds: float = 0.0,
        trace: bool = False, log=None) -> dict:
    """The cell's result line from the harness's functions, on the CPU."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    ctx = harness.Context(root=root, workload=workload, seed=seed,
                          seconds=seconds, trace=trace, device="cpu",
                          t0=harness.now(), log=log or (lambda m: None))
    return harness.run_cell(ctx)
