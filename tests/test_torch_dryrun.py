"""The port's dry run (``repro_torch.launch.dryrun``) and its cost
counter (``launch.op_analysis``) against the reference's
(``repro.launch.dryrun``, ``launch.hlo_analysis``).

Nothing here joins a process group or imports the reference's dry run
in the pytest worker: the reference runs in one subprocess on an
8-device CPU platform (importing ``repro.launch.dryrun`` sets
``XLA_FLAGS``, so it comes after ``jax.devices()``), the port's dry run
in another, with its own fake process group, and the real step of one
cell as 4 spawned gloo ranks (``tests/_multirank.py``); all of them on
core ``CORE`` at nice 10.

Gates:
- every (arch, shape, mesh): ``pick_strategy``, the skip, the record's
  key and ``model_flops`` equal the reference's exactly;
- smoke configs on a (data 2, model 4) mesh (``CELLS``): the port's
  per-device argument bytes equal those of the reference's compiled
  cell (``memory_analysis``, built as its ``build_cell`` builds one,
  with the switches its dry run sets for the cells' variant, baseline:
  scan flash, float32-cast logits, ``head_dim`` head TP; the port's run
  sets the same) exactly, and its FLOPs a device within ``FLOP_RTOL``
  of the reference's ``hlo_analysis`` count, a serving cell's on a
  (data 8, model 1) mesh, and on (data 2, model 4) at most
  ``MESH_OVER`` above it (``test_flops_...`` says where they part and
  why);
- rank 0 of a fake 4-rank run and rank 0 of a real 4-gloo-rank run of
  the same cell: equal argument bytes, ``COLLECTIVE_BYTES``, FLOPs and
  bytes;
- the ``fused`` variant builds through ``packed_input_spec`` and the
  ``repro_torch::bitunpack`` operator, the ``compressed`` one on the
  pod axis;
- counts carried from two depths (and three micro-batches) equal the
  whole run's at a small depth, memory included, for every family;
- one full-width cell through the CLI writes a record with the
  reference's keys."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from _multirank import ROOT, _ranks, _reference

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import dryrun as dr

CORE = -6
SEQ = 64
MESH = (2, 4)
# tag: (arch, kind, global batch)
CELLS = {
    "yi_9b/train": ("yi_9b", "train", 16),
    "deepseek_v2_lite_16b/train": ("deepseek_v2_lite_16b", "train", 16),
    "rwkv6_3b/train": ("rwkv6_3b", "train", 16),
    "zamba2_2p7b/train": ("zamba2_2p7b", "train", 16),
    "yi_9b/prefill": ("yi_9b", "prefill", 8),
    "deepseek_v2_lite_16b/decode": ("deepseek_v2_lite_16b", "decode", 8),
    "rwkv6_3b/decode": ("rwkv6_3b", "decode", 8),
    "zamba2_2p7b/decode": ("zamba2_2p7b", "decode", 8),
}
# the serving cells' FLOPs are compared on (data 8, model 1) as well
FLAT = (8, 1)
# the port's FLOPs a device against the reference's count: within
# FLOP_NOTED, or within FLOP_RTOL for a cell whose gap GAPS explains
FLOP_RTOL = 0.10
FLOP_NOTED = 0.02
# Measured on these cells (port over reference): train +0.35% (rwkv6_3b)
# to +3.42% (deepseek_v2_lite_16b); serving equal on FLAT, above on MESH.
# With the baseline's HEAD_TP "head_dim" and "cast": train +0.35%
# (rwkv6_3b), +1.88% (zamba2_2p7b), +2.11% (yi_9b), +3.42%
# (deepseek_v2_lite_16b); serving equal on FLAT.
RECOMPUTE = ("torch.utils.checkpoint recomputes every product of a "
             "checkpointed region in the backward (the remat blocks, the "
             "cross-entropy chunks, the scan flash's steps); the compiled "
             "program merges part of that recompute with the forward's "
             "products (the gap shrinks but stays at remat='none', where "
             "the cross-entropy chunks and flash steps are still "
             "checkpointed)")
GAPS = {"yi_9b/train": RECOMPUTE, "deepseek_v2_lite_16b/train": RECOMPUTE}
# a serving cell's FLOPs a device on MESH over the reference's: at least
# 1 and at most the limit (measured 1.0629, 1.0000, 1.5926 and 1.1415 in
# this order, the cells built as the baseline variant: HEAD_TP
# "head_dim"; 1.2605 and 1.3679 for yi_9b and zamba2_2p7b with
# "padded"): the port runs the products of the leaves the model axis
# leaves whole on every model rank, where GSPMD splits their contraction
# over it and all-reduces; the cause names those leaves
MESH_OVER = {
    "deepseek_v2_lite_16b/decode": (1.07, "MLA's wdkv, the MoE router"),
    "yi_9b/prefill": (1.001, "none: head_dim splits wq, wk, wv and wo "
                             "on the head dimension, so no product runs "
                             "whole on every model rank"),
    "rwkv6_3b/decode": (1.60, "the time mix's wk, wr, wlA and wlB, the "
                              "channel mix's wr_c"),
    "zamba2_2p7b/decode": (1.15, "Mamba2's wB, wC and wdt (head_dim "
                                 "splits the shared attention's wk and "
                                 "wv)"),
}
# the small-depth check of the carried counts: (arch, kind, mesh shape,
# layers, global batch)
DEPTHS = {
    "yi_9b/train": ("yi_9b", "train", (2, 4), 4, 16),
    "deepseek_v2_lite_16b/train": ("deepseek_v2_lite_16b", "train", (2, 4),
                                   4, 16),
    "rwkv6_3b/train/fsdp_dp": ("rwkv6_3b", "train", (2, 2, 2), 4, 32),
    "zamba2_2p7b/train": ("zamba2_2p7b", "train", (2, 4), 8, 16),
    "yi_9b/decode": ("yi_9b", "decode", (2, 4), 5, 8),
    "rwkv6_3b/prefill": ("rwkv6_3b", "prefill", (2, 4), 5, 8),
    "zamba2_2p7b/decode": ("zamba2_2p7b", "decode", (2, 4), 10, 8),
}
REAL_CELL = ("deepseek_v2_lite_16b", "train", (2, 2), 8)
CLI_CELL = ("deepseek_v2_lite_16b", "decode_32k")
# the reference's record (repro/launch/dryrun.py::run_cell)
REF_KEYS = {"arch", "shape", "mesh", "variant", "remat", "ok", "strategy",
            "n_devices", "lower_s", "compile_s", "memory",
            "hlo_flops_per_dev", "hlo_bytes_per_dev", "hlo_bytes_upper",
            "xla_raw_flops", "xla_raw_bytes", "collective",
            "collective_count", "model_flops_total", "useful_flops_ratio",
            "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes",
              "alias_bytes", "peak_hbm_bytes"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "step_s_bound", "roofline_fraction"}


# ------------------------------------------------- the reference's run
PROG = """
assert len(jax.devices()) == 8
from repro.launch.dryrun import cell_path, model_flops, pick_strategy, resolve_tree
from repro.launch.hlo_analysis import analyze
from repro.configs import base
from repro.distributed import sharding as shd
from repro.models import attention as _attn
from repro.models import layers as _layers
from repro.models import transformer as _tfm
from repro.models.archs import build_model
from repro.models.inputs import decode_input_specs, train_input_specs
from repro.train.optimizer import OptConfig
from repro.train.steps import abstract_train_state, make_train_step

for arch in base.registry():
    cfg = base.get_config(arch)
    for sname, shape in base.SHAPES.items():
        for multi in (False, True):
            mname = "pod2x16x16" if multi else "pod16x16"
            rec = {"arch": arch, "shape": sname, "mesh": mname,
                   "variant": "baseline", "remat": "full"}
            t = f"cell/{arch}/{sname}/{mname}"
            OUT[t + "/strategy"] = np.array(pick_strategy(cfg, shape, multi))
            OUT[t + "/skip"] = np.array(sname not in cfg.supported_shapes)
            OUT[t + "/key"] = np.array(cell_path(rec).name)
            OUT[t + "/model_flops"] = np.array(model_flops(cfg, shape))

# the cells' variant, baseline, as repro/launch/dryrun.py sets its switches
_attn.FLASH_IMPL, _attn.HEAD_TP = "scan", "head_dim"
_layers.XENT_MM, _tfm.KV_CACHE_QUANT = "cast", False
def compiled_cell(arch, kind, B, mesh):
    cfg = base.get_config(arch, smoke=True)
    shape = base.ShapeSpec("t", SEQ, B, kind)
    model = build_model(cfg, remat="full")
    rules = shd.MeshRules(mesh, strategy=pick_strategy(cfg, shape, False))
    if kind == "train":
        step = make_train_step(model, OptConfig())
        shapes, specs = abstract_train_state(model, cfg.opt_dtype)
        batch, batch_specs = train_input_specs(cfg, shape)
        in_sh = (resolve_tree(rules, specs, shapes),
                 resolve_tree(rules, batch_specs))
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=(in_sh[0], None),
                     donate_argnums=(0,))
        args = (shapes, batch)
    elif kind == "prefill":
        pshapes, pspecs = model.abstract()
        batch, batch_specs = train_input_specs(cfg, shape)
        batch = {k: v for k, v in batch.items() if k != "labels"}
        batch_specs = {k: v for k, v in batch_specs.items() if k != "labels"}
        _, cache_specs = model.abstract_cache(B, SEQ)
        fn = jax.jit(lambda p, b: model.prefill(p, b),
                     in_shardings=(resolve_tree(rules, pspecs, pshapes),
                                   resolve_tree(rules, batch_specs)),
                     out_shardings=(None, resolve_tree(rules, cache_specs)))
        args = (pshapes, batch)
    else:
        pshapes, pspecs = model.abstract()
        cache, cache_specs = model.abstract_cache(B, SEQ)
        tokens, tok_spec = decode_input_specs(cfg, shape)
        cache_sh = resolve_tree(rules, cache_specs)
        fn = jax.jit(model.decode_step,
                     in_shardings=(resolve_tree(rules, pspecs, pshapes),
                                   resolve_tree(rules, tok_spec), cache_sh),
                     out_shardings=(None, cache_sh), donate_argnums=(2,))
        args = (pshapes, tokens, cache)
    with shd.use_rules(rules):
        return fn.lower(*args).compile()

for tag, (arch, kind, B) in CELLS.items():
    compiled = compiled_cell(arch, kind, B, mesh_of(MESH, ("data", "model")))
    OUT[tag + "/argument_bytes"] = np.array(
        compiled.memory_analysis().argument_size_in_bytes)
    OUT[tag + "/flops"] = np.array(analyze(compiled.as_text())["flops"])
    if kind != "train":
        compiled = compiled_cell(arch, kind, B,
                                 mesh_of(FLAT, ("data", "model")))
        OUT[tag + "/flat_flops"] = np.array(
            analyze(compiled.as_text())["flops"])
"""


# ------------------------------------------------------ the port's runs
PORT = """
import json, os, sys, dataclasses
from pathlib import Path
_cores = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, {_cores[CORE % len(_cores)]})
os.nice(10)
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as dr

OUT = {}
orig = dr.get_config

def cell(arch, kind, B, mesh, **kw):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return dr.run_cell(arch, name, multi_pod=len(mesh) == 3, device="cpu",
                       smoke=True, mesh_shape=mesh,
                       shape=ShapeSpec("t", SEQ, B, kind), **kw)

for tag, (arch, kind, B) in CELLS.items():
    OUT["cell/" + tag] = cell(arch, kind, B, MESH)
    if kind != "train":
        OUT["flat/" + tag] = cell(arch, kind, B, FLAT)

# fused and compressed variants
OUT["fused"] = cell("yi_9b", "train", 16, MESH, variant="fused")
OUT["compressed"] = cell("yi_9b", "train", 16, (2, 2, 2),
                         variant="compressed")
with dr.fake_process_group(8):
    mesh = dr._mesh(False, "cpu", MESH)
    rules = shd.MeshRules(mesh, strategy="fsdp")
    cfg = get_config("yi_9b", smoke=True)
    res = dr.count_once(cfg, ShapeSpec("t", SEQ, 16, "train"), rules,
                        "fused", "full", "cpu")
    OUT["fused_calls"] = res["calls"]

# carried counts against the whole depth
for tag, (arch, kind, mesh, layers, B) in DEPTHS.items():
    dr.get_config = lambda a, smoke=False, n=layers: dataclasses.replace(
        orig(a, smoke=smoke), n_layers=n)
    OUT["depth/" + tag] = [cell(arch, kind, B, mesh, scale=s)
                           for s in (True, False)]
    dr.get_config = orig

# the fake half of fake against real
arch, kind, mesh, B = REAL_CELL
with dr.fake_process_group(4):
    rules = shd.MeshRules(dr._mesh(False, "cpu", mesh), strategy="fsdp")
    shd.reset_collective_bytes()
    res = dr.count_once(get_config(arch, smoke=True),
                        ShapeSpec("t", SEQ, B, kind), rules, "baseline",
                        "full", "cpu")
    res["collective_bytes"] = dict(shd.COLLECTIVE_BYTES)
    res.pop("calls", None)
    OUT["fake"] = res
Path(sys.argv[1]).write_text(json.dumps(OUT, default=float))
"""


def _port(tmp: Path) -> dict:
    consts = "".join(f"{k} = {v!r}\n" for k, v in dict(
        CORE=CORE, SEQ=SEQ, MESH=MESH, FLAT=FLAT, CELLS=CELLS, DEPTHS=DEPTHS,
        REAL_CELL=REAL_CELL).items())
    code = consts + textwrap.dedent(PORT)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "port.json")],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-6000:]
    return json.loads((tmp / "port.json").read_text())


def _job_real(rank: int, tmp) -> dict:
    """Rank ``rank`` of the real run of ``REAL_CELL`` (seeded weights,
    real tensors, gloo)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh

    arch, kind, mesh, B = REAL_CELL
    rules = shd.MeshRules(make_smoke_mesh(mesh, ("data", "model"), "cpu"),
                          strategy="fsdp")
    shd.reset_collective_bytes()
    res = dr.count_once(get_config(arch, smoke=True),
                        ShapeSpec("t", SEQ, B, kind), rules, "baseline",
                        "full", "cpu", fake=False)
    out = {k: np.array(res[k]) for k in ("argument_bytes", "flops", "bytes",
                                         "dots", "collective_count")}
    out.update({f"coll/{k}": np.array(v) for k, v in
                shd.COLLECTIVE_BYTES.items()})
    out.update({f"op/{k}": np.array(v) for k, v in
                res["collective"].items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref = _reference(PROG, tmp, core=CORE, devices=8, CELLS=CELLS, SEQ=SEQ,
                     MESH=MESH, FLAT=FLAT)
    port = _port(tmp)
    real = _ranks(_job_real, tmp, CORE)
    return ref, port, real


# ================================================= what each cell is
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_strategy_skip_key_and_model_flops_equal_reference(runs, arch,
                                                           shape):
    ref = runs[0]
    cfg = get_config(arch)
    for multi in (False, True):
        mname = dr.mesh_name(multi)
        t = f"cell/{arch}/{shape}/{mname}"
        assert dr.pick_strategy(cfg, SHAPES[shape], multi) == str(
            ref[t + "/strategy"])
        assert (shape not in cfg.supported_shapes) == bool(ref[t + "/skip"])
        rec = {"arch": arch, "shape": shape, "mesh": mname,
               "variant": "baseline", "remat": "full"}
        assert dr.cell_path(rec).name == str(ref[t + "/key"])
        assert dr.cell_path(rec).parent == dr.RESULTS_DIR
        assert dr.model_flops(cfg, SHAPES[shape]) == float(
            ref[t + "/model_flops"])
        if shape not in cfg.supported_shapes:
            skipped = dr.run_cell(arch, shape, multi_pod=multi)
            assert skipped["skipped"] and not skipped["ok"]
            assert skipped["reason"] == dr.SKIP_REASON


# ============================================ against the compiled cell
@pytest.mark.parametrize("tag", sorted(CELLS))
def test_argument_bytes_equal_the_compiled_cell(runs, tag):
    ref, port, _ = runs
    rec = port["cell/" + tag]
    assert rec["ok"], rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == int(ref[tag + "/argument_bytes"])
    assert rec["n_devices"] == 8


@pytest.mark.parametrize("tag", sorted(CELLS))
def test_flops_per_device_near_the_compiled_cell(runs, tag):
    """The port's FLOPs a device against the reference's HLO count of
    the same cell: within ``FLOP_NOTED``, or, for a cause ``GAPS``
    names, ``FLOP_RTOL``.  A serving cell is held on ``FLAT``, where no
    rank repeats another's work; on ``MESH`` the port's count is above
    the reference's, within the limit ``MESH_OVER`` sets with its
    cause: products whose weights the model axis does not split run
    whole on every model rank, where GSPMD splits their contraction
    over the model axis and all-reduces."""
    ref, port, _ = runs
    kind = CELLS[tag][1]
    if kind == "train":
        got = port["cell/" + tag]["hlo_flops_per_dev"]
        want = float(ref[tag + "/flops"])
    else:
        got = port["flat/" + tag]["hlo_flops_per_dev"]
        want = float(ref[tag + "/flat_flops"])
        over = port["cell/" + tag]["hlo_flops_per_dev"] / float(
            ref[tag + "/flops"])
        limit, cause = MESH_OVER[tag]
        assert 1.0 <= over <= limit, (tag, over, cause)
    assert got > 0 and want > 0
    rel = abs(got - want) / want
    assert rel <= FLOP_RTOL, (got, want, rel)
    if rel > FLOP_NOTED:
        assert tag in GAPS, (tag, got, want, rel)


# ========================================================= fake vs real
def test_fake_rank_equals_a_real_gloo_rank(runs):
    _, port, real = runs
    fake = port["fake"]
    r0 = real[0]
    assert fake["argument_bytes"] == int(r0["argument_bytes"])
    assert fake["flops"] == float(r0["flops"])
    assert fake["bytes"] == float(r0["bytes"])
    assert fake["dots"] == float(r0["dots"])
    assert fake["collective_count"] == float(r0["collective_count"])
    for k, v in fake["collective_bytes"].items():
        assert v == int(r0[f"coll/{k}"]), k
    for k, v in fake["collective"].items():
        assert v == float(r0[f"op/{k}"]), k
    assert sum(fake["collective_bytes"].values()) > 0
    # the dispatch counter and the module's counter agree
    assert fake["collective"]["all-gather"] == \
        fake["collective_bytes"]["all_gather"]
    assert fake["collective"]["reduce-scatter"] == \
        fake["collective_bytes"]["reduce_scatter"]


# ============================================================ variants
def test_fused_variant_builds_through_packed_words_and_bitunpack(runs):
    _, port, _ = runs
    rec = port["fused"]
    assert rec["ok"], rec.get("traceback")
    assert rec["switches_not_ported"] == []
    assert rec["switches"] == {"FLASH_IMPL": "vjp", "HEAD_TP": "padded",
                               "XENT_MM": "mixed", "KV_CACHE_QUANT": False}
    calls = port["fused_calls"]
    assert calls.get("repro_torch.bitunpack.default") == 1, sorted(calls)
    base = port["cell/yi_9b/train"]
    # packed words in, (B, S) int32 tokens and labels no longer read
    assert rec["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]


def test_compressed_variant_builds_on_the_pod_axis(runs):
    _, port, _ = runs
    rec = port["compressed"]
    assert rec["ok"], rec.get("traceback")
    assert rec["strategy"] == "megatron_sp"
    assert rec["collective"]["all-reduce"] > 0


def test_variant_switches_name_what_the_port_lacks():
    """Each variant sets the reference's switches as its dry run sets
    them (``repro/launch/dryrun.py:201-206``), and the port lacks none."""
    assert dr.variant_switches("baseline") == (
        {"FLASH_IMPL": "scan", "HEAD_TP": "head_dim", "XENT_MM": "cast",
         "KV_CACHE_QUANT": False}, [])
    assert dr.variant_switches("flashvjp") == (
        {"FLASH_IMPL": "vjp", "HEAD_TP": "head_dim", "XENT_MM": "cast",
         "KV_CACHE_QUANT": False}, [])
    assert dr.variant_switches("kvint8") == (
        {"FLASH_IMPL": "vjp", "HEAD_TP": "padded", "XENT_MM": "mixed",
         "KV_CACHE_QUANT": True}, [])
    for v in ("optimized", "fused", "compressed"):
        assert dr.variant_switches(v) == (
            {"FLASH_IMPL": "vjp", "HEAD_TP": "padded", "XENT_MM": "mixed",
             "KV_CACHE_QUANT": False}, [])


# ======================================================= carried counts
@pytest.mark.parametrize("tag", sorted(DEPTHS))
def test_carried_counts_equal_the_whole_depth(runs, tag):
    _, port, _ = runs
    scaled, whole = port["depth/" + tag]
    assert scaled["ok"] and whole["ok"]
    assert scaled["scaled"]["at"] != [scaled["scaled"]["units"]]
    for k in ("memory", "hlo_flops_per_dev", "hlo_bytes_per_dev",
              "hlo_bytes_upper", "collective", "collective_count", "ops"):
        assert scaled[k] == whole[k], k
    if "fsdp_dp" in tag:
        assert scaled["micro"] == whole["micro"] == 8
        assert scaled["scaled"]["micro_run"] == dr.RUN_MICRO


# ================================================================ CLI
def _cli(*args) -> subprocess.CompletedProcess:
    """The dry run's CLI in a subprocess on ``CORE`` at nice 10."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    quiet = (f"import os; _c = sorted(os.sched_getaffinity(0)); "
             f"os.sched_setaffinity(0, {{_c[{CORE} % len(_c)]}}); "
             "os.nice(10); from repro_torch.launch.dryrun import main; main()")
    return subprocess.run([sys.executable, "-c", quiet, *args], env=env,
                          capture_output=True, text=True, timeout=600)


def test_one_full_width_cell_through_the_cli(tmp_path):
    arch, shape = CLI_CELL
    out = _cli("--arch", arch, "--shape", shape, "--device", "cpu",
               "--out", str(tmp_path))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}.{shape}.pod16x16.baseline.full"
                                  ".json").read_text())
    assert rec["ok"] and REF_KEYS <= set(rec)
    assert set(rec["memory"]) == REF_MEMORY
    assert REF_ROOFLINE <= set(rec["roofline"])
    assert rec["n_devices"] == 256 and rec["strategy"] == "tp_sp"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["peak_hbm_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["hlo_flops_per_dev"] > 0 and rec["collective"]["total"] > 0


def test_cli_fails_a_cell_that_fails(tmp_path):
    """A cell that cannot build is written ``ok: false`` and the CLI
    exits non-zero, as the reference's does."""
    out = _cli("--arch", "musicgen_large", "--shape", "train_4k",
               "--variant", "fused", "--device", "cpu", "--out",
               str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["ok"] is False and "frontend" in rec["error"]
