"""Multi-pod dry run of the port: one rank's step of every (arch x shape
x mesh) cell on fake tensors, the counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's ``jax.jit`` step on a
faked 256- or 512-device platform and reads the roofline terms from the
compiled program.  The port has no compiler to ask, so a cell here
starts a fake process group of that many ranks in this process alone
(``torch.distributed``'s test backend, imported in
:func:`fake_process_group` and nowhere else), builds the production mesh
(``launch.mesh.make_production_mesh``) and runs rank 0's step under
``torch``'s ``FakeTensorMode``: the model, its sharded state (``train.
steps.shard_train_state`` / ``shard_params``), the rank's block of the
batch and of the cache are fake tensors of the rank's local shapes, on
``device`` ("cuda" by default; the tests ask for the CPU), and every
collective returns at once.  One step runs (train; prefill; decode with
its cache) under the port's sharding rules (``distributed.sharding``),
counted by ``launch.op_analysis.OpCounter``: FLOPs, bytes, wire bytes by
kind, and the memory of the fake tensors (arguments, and the largest
live total during the step).

Depth.  The port runs its layers (and micro-batches) as Python loops,
and a fake step costs about a millisecond an operator, so a cell is
counted at two depths a block apart (a block: a layer; zamba's group of
``attn_every`` Mamba2 layers and its shared block; the MoE family's
routed layers after its dense ones), one and two blocks for a train
step, two and three for a serving step and zamba's (whose memory at
one block lies off the line), and every count, memory included, is carried to the
config's depth along the line through the two, as the reference's
analyzer multiplies a ``while`` body by its trip count.  A
step of several micro-batches is counted at two, and one micro-batch's
counts (between ``make_train_step``'s ``on_microbatch`` calls) carried
to the config's number.  ``tests/test_torch_dryrun.py`` holds the
carried counts equal to the full run's at a small depth
(``run_cell(scale=False)`` runs the config's whole depth).

Variants set the reference's switches as its dry run sets them
(``attention.FLASH_IMPL`` and ``HEAD_TP``, ``layers.XENT_MM``,
``transformer.KV_CACHE_QUANT``, packed ingest and the int8 pod hop),
before the model is built; each record names them (``switches``), and
its ``switches_not_ported`` (a switch of the reference's variant that
the port lacks) is empty.

The roofline uses an H100 SXM's published peaks (989 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 450 GB/s of NVLink a direction), not the
reference's TPU constants; ``roofline_reference_tpu_constants`` applies
those (``REFERENCE_TPU``) to the same counts, to set the port's terms
beside the reference's, and is no measurement.  The production mesh's
axes span nodes of 8 cards, which NVLink does not join, so its
collective term is a lower bound.  Serving steps run with autograd off,
as the serve engine runs them.

Records go to ``results/dryrun_torch/<key>.json``, keyed as the
reference's ``cell_path`` keys them; the CLI exits non-zero if a cell
fails (its record says ``ok: false``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  ... --mesh multi       # the 2-pod (2, 16, 16) mesh instead of (16, 16)
  ... --variant fused    # the packed-ingest train step
  ... --variant compressed  # the int8 cross-pod gradient sync (multi only)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, get_config, registry
from repro_torch.distributed import sharding as shd

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

# H100 SXM (the hopper-kernels guide's table)
PEAK_FLOPS = 989e12          # dense bf16, FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s each way
# the reference's TPU v5e-class constants (repro/launch/dryrun.py:46-48),
# applied to the port's counts only to set them beside the reference's
# terms; no measurement of either
REFERENCE_TPU = {"flops": 197e12, "hbm": 819e9, "link": 50e9}

SKIP_REASON = "long_500k needs sub-quadratic attention"
SSM_CHUNK_OVERRIDE: int | None = None
# micro-batches a sampled run takes: from the third on, each micro-batch
# repeats the one before it (the first starts the sums, the second adds
# to the first's own metric tensors)
RUN_MICRO = 3


# --------------------------------------------------------------------------
# what the reference decides per cell
# --------------------------------------------------------------------------


def pick_strategy(cfg, shape, multi_pod: bool) -> str:
    """The reference's parallelism strategy per workload: train is FSDP
    on one pod, Megatron-SP across pods or for grok, and FSDP with a
    pod-replicated batch for the recurrent families across pods;
    serving is always TP with a sequence-sharded cache."""
    if shape.kind != "train":
        return "tp_sp"
    if cfg.family in ("ssm", "hybrid"):
        return "fsdp_dp" if multi_pod else "fsdp"
    if multi_pod or cfg.name.startswith("grok"):
        return "megatron_sp"
    return "fsdp"


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 tok/seq


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_key(arch: str, shape: str, mesh: str, variant: str, remat: str,
             strategy: str | None = None, ssm_chunk: int | None = None
             ) -> str:
    key = f"{arch}.{shape}.{mesh}.{variant}.{remat}"
    if strategy:
        key += f".{strategy}"
    if ssm_chunk:
        key += f".c{ssm_chunk}"
    return key


def cell_path(rec_or_key, results: pathlib.Path | None = None
              ) -> pathlib.Path:
    if isinstance(rec_or_key, dict):
        r = rec_or_key
        key = cell_key(r["arch"], r["shape"], r["mesh"], r["variant"],
                       r["remat"])
    else:
        key = rec_or_key
    return (results or RESULTS_DIR) / f"{key}.json"


def variant_switches(variant: str) -> tuple[dict, list[str]]:
    """(the port's switches, the reference's switches the variant flips
    that the port does not have: none), as ``repro/launch/dryrun.py``
    sets them for each variant: baseline (scan flash, float32-cast
    logits, ``head_dim`` head TP), flashvjp (the flash backward),
    optimized and everything built on it (mixed-precision logits, padded
    head TP), kvint8 (the int8 decode cache)."""
    early = variant in ("baseline", "flashvjp")
    port = {"FLASH_IMPL": "scan" if variant == "baseline" else "vjp",
            "HEAD_TP": "head_dim" if early else "padded",
            "XENT_MM": "cast" if early else "mixed",
            "KV_CACHE_QUANT": variant == "kvint8"}
    return port, []


@contextlib.contextmanager
def _switches(variant: str):
    from repro_torch.models import attention, layers, transformer

    port, _ = variant_switches(variant)
    home = {"FLASH_IMPL": attention, "HEAD_TP": attention,
            "XENT_MM": layers, "KV_CACHE_QUANT": transformer}
    old = {k: getattr(home[k], k) for k in port}
    for k, v in port.items():
        setattr(home[k], k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(home[k], k, v)


# --------------------------------------------------------------------------
# the fake process group and mesh
# --------------------------------------------------------------------------


@contextlib.contextmanager
def fake_process_group(world: int):
    """A process group of ``world`` fake ranks, this process rank 0:
    every collective returns at once.  Torch ships the backend in its
    test utilities (a private path, imported here only)."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg as fake_pg

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group; one "
                           "is already initialised in this process")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        shd.clear_groups()
        dist.destroy_process_group()


def _mesh(multi_pod: bool, device: str, shape: tuple | None = None):
    """The production mesh, or a mesh of ``shape`` over ("data",
    "model") (with "pod" first when it has three axes)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_production_mesh

    if shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    names = ("pod", "data", "model")[-len(shape):]
    return DeviceMesh(device, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


# --------------------------------------------------------------------------
# one counted run
# --------------------------------------------------------------------------


def depth_units(cfg) -> tuple[int, int, int]:
    """(the blocks that repeat, layers a block, layers before them) of
    ``cfg``: a layer; zamba's group of ``attn_every`` Mamba2 layers (and
    its shared block); the MoE family's routed layers after the dense
    ``first_dense``."""
    per = cfg.ssm.attn_every if cfg.family == "hybrid" else 1
    pre = cfg.moe.first_dense if cfg.moe is not None else 0
    return (cfg.n_layers - pre) // per, per, pre


def at_depth(cfg, units: int):
    _, per, pre = depth_units(cfg)
    return dataclasses.replace(cfg, n_layers=pre + per * units)


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storages(tree) -> set:
    from torch.utils._pytree import tree_leaves
    return {id(t.untyped_storage()) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


@dataclasses.dataclass
class Built:
    """A cell's step, ready to run on fake tensors."""
    run: object            # () -> outputs
    arguments: tuple       # the rank's local state / params, batch, cache
    held: tuple            # other tensors the step's caller holds
    micro: int             # micro-batches of the step


def build_cell(cfg, shape, rules, variant: str, remat: str, device: str,
               batch: int | None = None, micro: int | None = None,
               on_microbatch=None, init: bool = False) -> Built:
    """The cell's model, state and inputs as tensors of this rank's
    local shapes: fake ones under a ``FakeTensorMode`` (the weights
    left as they are), real ones with ``init`` (seeded weights).
    ``batch`` overrides the global batch (the micro-batch sampling),
    ``micro`` the train step's micro-batches (the reference's: 8 under
    ``fsdp_dp`` / ``tp_dp``, else 1)."""
    from repro_torch.models import inputs
    from repro_torch.models.archs import build_model
    from repro_torch.train import steps
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    model = build_model(cfg, remat=remat, device=device)
    if init:
        model.init(torch.Generator(device=device).manual_seed(0))
    B = batch or shape.global_batch
    S = shape.seq_len

    def zeros(meta: torch.Tensor) -> torch.Tensor:
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)

    if shape.kind == "train":
        if micro is None:
            micro = reference_micro(rules, variant)
        params = dict(model.named_parameters())
        state = {"params": params,
                 "opt": init_opt_state(params, cfg.opt_dtype)}
        state = steps.shard_train_state(model, state, rules)
        opt = OptConfig()
        if variant == "compressed":
            if "pod" not in rules.all_axes:
                raise SystemExit("compressed variant needs the pod axis")
            from repro_torch.distributed import compression
            state = compression.init_compressed_state(state, rules)
            step = compression.make_compressed_train_step(model, opt, rules)
        else:
            step = steps.make_train_step(model, opt, microbatches=micro,
                                         on_microbatch=on_microbatch)
        whole = {k: zeros(v) for k, v in inputs.train_input_specs(
            cfg, dataclasses.replace(shape, global_batch=B))[0].items()}
        if variant == "fused":
            if cfg.frontend != "none":
                raise SystemExit("fused variant needs a token frontend")
            from repro_torch.data import fused_ingest
            packed = zeros(fused_ingest.packed_input_spec(B, S,
                                                          cfg.vocab_size))
            local = shd.local_shard(packed, rules.sharding("dp", None, None))
            step = fused_ingest.make_fused_train_step(step)
        else:
            local = inputs.shard_batch(whole, rules, micro)
        del whole
        return Built(lambda: step(state, local), (state, local), (), micro)

    steps.shard_params(model, rules)
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        spec_batch = dataclasses.replace(shape, global_batch=B)
        whole = {k: zeros(v) for k, v in inputs.train_input_specs(
            cfg, spec_batch)[0].items() if k != "labels"}
        local = inputs.shard_batch(whole, rules)
        return Built(_serving(lambda: model.prefill(whole)), (params, local),
                     (whole,), 1)
    cache_shapes, cache_specs = model.abstract_cache(B, S)
    cache = {k: shd.local_shard(zeros(v), rules.named(rules.spec(
        *cache_specs[k]))) for k, v in cache_shapes.items()}
    meta, spec = inputs.decode_input_specs(cfg, dataclasses.replace(
        shape, global_batch=B))
    tokens = zeros(meta)
    local = shd.local_shard(tokens, rules.named(rules.spec(*spec)))
    return Built(_serving(lambda: model.decode_step(tokens, cache)),
                 (params, local, cache), (tokens,), 1)


def _serving(step):
    """A serving step as the serve engine runs it: autograd off."""
    def run():
        with torch.no_grad():
            return step()
    return run


def reference_micro(rules, variant: str) -> int:
    """The reference's micro-batches of a train step: 8 under
    ``fsdp_dp`` / ``tp_dp`` (the recurrent families' batch share across
    pods), else 1; the compressed step takes none."""
    if variant == "compressed":
        return 1
    return 8 if rules.strategy in ("fsdp_dp", "tp_dp") else 1


def count_once(cfg, shape, rules, variant: str, remat: str, device: str,
               batch: int | None = None, micro: int | None = None,
               fake: bool = True) -> dict:
    """One run of the cell's step under an ``OpCounter``, on fake
    tensors (or, ``fake`` False, real ones with seeded weights, on a
    real process group): its counts, argument and output bytes, and
    (with micro-batches) the counts of one micro-batch
    (``per_micro``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter

    counter = OpCounter()
    marks: list[dict] = []

    def mark(_i: int) -> None:
        marks.append(counter.result())

    t0 = time.perf_counter()
    with (FakeTensorMode() if fake else contextlib.nullcontext()), \
            _switches(variant):
        built = build_cell(cfg, shape, rules, variant, remat, device, batch,
                           micro, on_microbatch=mark, init=not fake)
        t1 = time.perf_counter()
        counter.track(built.arguments, built.held)
        arg_bytes = _bytes(built.arguments)
        before = _storages(built.arguments)
        with shd.use_rules(rules), counter:
            out = built.run()
        t2 = time.perf_counter()
        res = counter.result()
        alias = _bytes([t for t in _leaf_list(out)
                        if id(t.untyped_storage()) in before])
        res["calls"] = {str(k): v for k, v in counter.calls.items()}
        res.update(argument_bytes=arg_bytes, output_bytes=_bytes(out),
                   alias_bytes=alias, build_s=t1 - t0, run_s=t2 - t1,
                   micro=built.micro, batch_bytes=_bytes(built.arguments[1]))
    if len(marks) >= 3:
        res["per_micro"] = _diff(marks[2], marks[1])
    return res


def _leaf_list(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# the counts that scale with depth and micro-batches
_SCALED = ("flops", "bytes", "bytes_fused", "collective_count", "dots",
           "ops", "peak_bytes", "argument_bytes", "output_bytes",
           "alias_bytes")


def _diff(a: dict, b: dict) -> dict:
    out = {k: a[k] - b[k] for k in _SCALED if k in a and k in b}
    out["collective"] = {k: a["collective"][k] - b["collective"][k]
                         for k in a["collective"]}
    return out


def _line(one: dict, two: dict, n: float) -> dict:
    """The counts ``n - 1`` steps along the line from ``one`` (a run at
    some depth) through ``two`` (one block deeper), memory included."""
    out = {k: one[k] + (n - 1) * (two[k] - one[k])
           for k in _SCALED if k in one}
    out["collective"] = {k: one["collective"][k] + (n - 1) * (
        two["collective"][k] - one["collective"][k])
        for k in one["collective"]}
    return out


def _with_micro(res: dict, full_micro: int) -> dict:
    """A run of 2 micro-batches carried to ``full_micro``: one micro-
    batch's counts added ``full_micro - 2`` times more; its memory is
    the same each time, so the arguments and the peak grow by the
    batch's other micro-batches alone."""
    out = dict(res)
    per = res.get("per_micro")
    if per is None or full_micro == res["micro"]:
        return out
    extra = full_micro - res["micro"]
    more = extra * res["batch_bytes"] // res["micro"]
    out["argument_bytes"] = res["argument_bytes"] + more
    out["peak_bytes"] = res["peak_bytes"] + more
    for k in ("flops", "bytes", "bytes_fused", "collective_count", "dots",
              "ops"):
        out[k] = res[k] + extra * per[k]
    out["collective"] = {k: res["collective"][k] + extra * per[
        "collective"][k] for k in res["collective"]}
    out["micro"] = full_micro
    return out


def measure(cfg, shape, rules, variant: str, remat: str, device: str,
            scale: bool = True) -> dict:
    """The cell's counts at the config's depth and micro-batches: run
    whole (``scale`` False), or at one and two repeated blocks and two
    micro-batches and carried along (the module docstring)."""
    units, _, _ = depth_units(cfg)
    batch = None
    micro = reference_micro(rules, variant) if shape.kind == "train" \
        else 1
    micro = micro if micro > 1 else None
    if not scale:
        return dict(count_once(cfg, shape, rules, variant, remat, device,
                               micro=micro), sampled=None)
    if micro is not None:
        batch = shape.global_batch * RUN_MICRO // micro
        run_micro = RUN_MICRO
    else:
        run_micro = micro
    # memory follows the depth from one block on in a train step, from
    # two in a serving step (one block's cache and activations lie
    # apart) and in zamba's (its shared block's gradients are added up
    # from the second group on)
    first = 1 if shape.kind == "train" and cfg.family != "hybrid" else 2
    at = (first, first + 1) if units > first + 1 else (units,)
    runs = [count_once(at_depth(cfg, u), shape, rules, variant, remat,
                       device, batch=batch, micro=run_micro) for u in at]
    runs = [_with_micro(r, micro) if micro and batch else r for r in runs]
    res = _line(runs[0], runs[1], units - first + 1) if len(runs) == 2 \
        else dict(runs[0])
    res.update(build_s=sum(r["build_s"] for r in runs),
               run_s=sum(r["run_s"] for r in runs),
               micro=micro or 1, raw=runs[0],
               sampled={"units": units, "at": list(at),
                        "micro_run": run_micro})
    return res


# --------------------------------------------------------------------------
# a cell
# --------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str = "baseline", remat: str = "full",
             strategy: str | None = None, device: str = "cuda",
             smoke: bool = False, mesh_shape: tuple | None = None,
             shape=None, scale: bool = True) -> dict:
    """The record of one cell (the reference's keys).  ``smoke``,
    ``mesh_shape`` and ``shape`` (a ``ShapeSpec``) shrink it for tests:
    the smoke config on a mesh of that shape."""
    mesh = mesh_name(multi_pod) if mesh_shape is None else \
        "x".join(map(str, mesh_shape))
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh,
                 "variant": variant, "remat": remat, "ok": False,
                 "device": device,
                 "switches": variant_switches(variant)[0],
                 "switches_not_ported": variant_switches(variant)[1]}
    cfg = get_config(arch, smoke=smoke)
    if shape_name not in cfg.supported_shapes:
        rec.update(skipped=True, reason=SKIP_REASON)
        return rec
    if SSM_CHUNK_OVERRIDE and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=SSM_CHUNK_OVERRIDE))
    shape = shape or SHAPES[shape_name]
    strategy = strategy or pick_strategy(cfg, shape, multi_pod)
    rec["strategy"] = strategy
    n_dev = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod
                                                      else 256)
    with fake_process_group(n_dev):
        rules = shd.MeshRules(_mesh(multi_pod, device, mesh_shape),
                              strategy=strategy)
        res = measure(cfg, shape, rules, variant, remat, device, scale)

    flops_dev = float(res["flops"])
    bytes_dev = float(res["bytes_fused"])
    coll = dict(res["collective"])
    coll_dev = float(coll["total"])
    mf = model_flops(get_config(arch, smoke=smoke), shape)
    roofline = _roofline(flops_dev, bytes_dev, coll_dev, PEAK_FLOPS, HBM_BW,
                         LINK_BW)
    arg, out, alias = (int(res["argument_bytes"]), int(res["output_bytes"]),
                       int(res["alias_bytes"]))
    peak = int(res["peak_bytes"])
    raw = res.get("raw", res)
    rec.update(
        ok=True,
        n_devices=int(n_dev),
        lower_s=round(res["build_s"], 1), compile_s=round(res["run_s"], 1),
        memory=dict(argument_bytes=arg, output_bytes=out,
                    temp_bytes=peak - arg - out + alias, code_bytes=0,
                    alias_bytes=alias, peak_hbm_bytes=peak),
        hlo_flops_per_dev=flops_dev,
        hlo_bytes_per_dev=bytes_dev,
        hlo_bytes_upper=float(res["bytes"]),
        xla_raw_flops=float(raw["flops"]),
        xla_raw_bytes=float(raw["bytes"]),
        collective=coll,
        collective_count=float(res["collective_count"]),
        model_flops_total=mf,
        useful_flops_ratio=mf / max(flops_dev * n_dev, 1.0),
        roofline=roofline,
        ops=int(res["ops"]), micro=res["micro"], scaled=res["sampled"],
        peaks={"flops": PEAK_FLOPS, "hbm": HBM_BW, "link": LINK_BW},
        roofline_reference_tpu_constants=_roofline(
            flops_dev, bytes_dev, coll_dev, *REFERENCE_TPU.values()),
    )
    return rec


def _roofline(flops: float, nbytes: float, wire: float, peak: float,
              hbm: float, link: float) -> dict:
    compute_s, memory_s, coll_s = flops / peak, nbytes / hbm, wire / link
    bound = max(compute_s, memory_s, coll_s)
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    return dict(compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
                dominant=dom, step_s_bound=bound,
                roofline_fraction=compute_s / bound if bound else 0.0)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--strategy", default=None,
                    help="override the parallelism strategy for the cell")
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="override cfg.ssm.chunk (SSD/WKV chunk sweep)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu on a machine "
                         "without a card)")
    ap.add_argument("--out", default=None, help="records' directory")
    args = ap.parse_args(argv)
    if args.ssm_chunk:
        global SSM_CHUNK_OVERRIDE
        SSM_CHUNK_OVERRIDE = args.ssm_chunk
    if not args.all and not (args.arch or args.shape):
        ap.error("name --arch and/or --shape, or ask for --all")

    archs = [args.arch] if args.arch else list(registry())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = pathlib.Path(args.out) if args.out else RESULTS_DIR
    results.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                key = cell_key(arch, shape, mesh_name(multi), args.variant,
                               args.remat, args.strategy, args.ssm_chunk)
                path = cell_path(key, results)
                if path.exists() and not args.force:
                    print(f"[dryrun] {key}: cached", flush=True)
                    continue
                print(f"[dryrun] {key}: running...", flush=True)
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, multi_pod=multi,
                                   variant=args.variant, remat=args.remat,
                                   strategy=args.strategy,
                                   device=args.device)
                except (Exception, SystemExit) as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(multi),
                           "variant": args.variant, "remat": args.remat,
                           "ok": False, "error": repr(e)[:1000],
                           "traceback": traceback.format_exc()[-3000:]}
                    failures += 1
                rec["wall_s"] = time.perf_counter() - t0
                path.write_text(json.dumps(rec, indent=1))
                if rec.get("skipped"):
                    print(f"[dryrun] {key}: SKIP ({rec['reason']})",
                          flush=True)
                elif rec["ok"]:
                    r = rec["roofline"]
                    sw = rec["switches"]
                    print(f"[dryrun] {key}: OK {rec['wall_s']:.1f}s "
                          f"HEAD_TP={sw['HEAD_TP']} XENT_MM={sw['XENT_MM']} "
                          f"dom={r['dominant']} "
                          f"frac={r['roofline_fraction']:.2f} peak_hbm="
                          f"{rec['memory']['peak_hbm_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                else:
                    print(f"[dryrun] {key}: FAIL {rec['error'][:200]}",
                          flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
