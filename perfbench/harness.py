"""The benchmark's general part: find a cell's files by the names in
``BENCHMARK.json``, run its traffic kind, read its metrics, and build
the one result line.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its files are found by name:

  perfbench/configs/<config>.json    - the configuration (the entry's
                                       ``file``): the published keys, its
                                       cuts (``published``: the values cut
                                       from) and the program's
                                       ``departures``, the layer kinds,
                                       ``assumed``, and ``port``: how the
                                       program builds it
  perfbench/traffic/<traffic>.json   - the traffic's parameters; its
                                       ``kind`` names the general driver
                                       in perfbench/kinds/<kind>.py
  perfbench/cells/<workload>.json    - what belongs to the cell alone:
                                       ``limits``, the limit of each number
                                       that the comparison with the
                                       reference reads, and a training
                                       cell's ``optimizer``
  perfbench/metrics/<metric>.py      - each metric's reader: ``read(run)``
                                       returns its value, or None where
                                       the run has nothing to read

so a later cell, configuration, traffic mix or metric of an existing
kind is new files and entries, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable

PERFBENCH = Path(__file__).resolve().parent

# top-level module names that no process of the benchmark may hold: the
# JAX package the program was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload and every file it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    config_entry: dict    # its entry in BENCHMARK.json
    traffic: dict
    limits: dict
    optimizer: dict | None  # a training cell's optimizer settings
    end_to_end: list      # the metric entries that apply to this cell
    per_layer: list


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, its files read
    from ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({[w['name'] for w in bench['workloads']]})")
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    pb = root / "perfbench"
    own = load_json(pb / "cells" / f"{wl['name']}.json")
    return Cell(
        name=wl["name"], chips=wl["chips"],
        config=load_json(root / entry["file"]), config_entry=entry,
        traffic=load_json(pb / "traffic" / f"{wl['traffic']}.json"),
        limits=own["limits"], optimizer=own.get("optimizer"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, wl["name"])],
        per_layer=[m for m in bench["per_layer"] if applies(m, wl["name"])])


def load_reader(root: Path, name: str) -> Callable[[Any], float | None]:
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# what a run records
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What a traffic kind hands the metric readers.  Times are
    ``time.perf_counter()`` seconds; ``spans`` are (name, start, end) of
    the benchmark's own timers around the program's calls, kept only in
    a traced run where a reader needs them (the train kind's loader
    timer is kept in every run)."""

    spec: Any                       # reference.lm.Spec of the configuration
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)      # (start, end) of the measured window
    steps: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    trace: dict | None = None       # trace.reduce's summary
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    traffic: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_walls(self, name: str) -> list[float]:
        return [b - a for n, a, b in self.spans if n == name]


@dataclasses.dataclass
class Context:
    root: Path
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                       # perf_counter at process start
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr,
                                                   flush=True)


def log_setup(ctx: Context, marks: list[tuple[str, float]]) -> None:
    """One line of the set-up's parts: each mark's seconds since the one
    before it, the first since the process started."""
    parts, t = [], ctx.t0
    for name, at in marks:
        parts.append(f"{name} {at - t:.2f} s")
        t = at
    ctx.log("setup: " + ", ".join(parts))


def port_modules(root: Path):
    """The program's modules a cell uses, imported from the checkout's
    ``src`` (the program: ``repro_torch``)."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core as core
    from repro_torch import configs
    from repro_torch.core import format as fmt
    from repro_torch.core.partition import PartitionPolicy
    from repro_torch.data import corpus, pipeline
    from repro_torch.models import archs
    from repro_torch.serve import engine
    from repro_torch.train import optimizer, trainer
    return dict(
        core=core, configs=configs, fmt=fmt, PartitionPolicy=PartitionPolicy,
        corpus=corpus, pipeline=pipeline, archs=archs,
        engine=engine, optimizer=optimizer, trainer=trainer)


def port_config(P: dict, cfg: dict):
    """The program's ``ArchConfig`` of a configuration file: its ``port``
    block's registered architecture (or its smoke version), with the
    block's replacements; every published key that ``port.keys`` maps to
    an attribute must then hold the file's value, so the program runs
    the sizes the file states."""
    import torch

    from perfbench.reference import lm

    port = cfg["port"]
    arch = P["configs"].get_config(port["arch"], smoke=port.get("smoke",
                                                                False))
    rep = dict(port.get("replace", {}))
    for group in ("moe", "mla"):
        if group in rep:
            rep[group] = dataclasses.replace(getattr(arch, group),
                                             **rep[group])
    for k in ("param_dtype", "compute_dtype", "opt_dtype"):
        if k in rep:
            rep[k] = getattr(torch, rep[k])
    arch = dataclasses.replace(arch, **rep)
    bad = []
    for key, attr in port["keys"].items():
        have = arch
        for a in attr.split("."):
            have = getattr(have, a)
        want = lm.as_run(cfg)[key]
        if isinstance(have, torch.dtype):
            have = str(have).removeprefix("torch.")
        if (have != want if not isinstance(want, float)
                else not math.isclose(have, want, rel_tol=1e-12)):
            bad.append(f"{key}: file {want!r}, program {attr} {have!r}")
    if bad:
        raise SystemExit("perfbench: the program's configuration differs "
                         "from the file's: " + "; ".join(bad))
    return arch


# --------------------------------------------------------------------------
# the result line
# --------------------------------------------------------------------------


def device_info(ctx: Context, chips: int, peak: int) -> dict:
    import torch

    if ctx.device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def within(checks: dict) -> bool:
    """Every number read and within its limit (a number the run could
    not read, as the reference's where a consumed row is wrong, is
    null)."""
    return all(c["value"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def run_cell(ctx: Context) -> dict:
    """Run the cell and return its result line (a dict, ``checks``
    last)."""
    cell = find_cell(ctx.root, ctx.workload)
    name = cell.config_entry["name"]
    for key, was in cell.config.get("published", {}).items():
        ctx.log(f"reduced: {name} {key} {was!r} -> "
                f"{cell.config.get(key)!r}: {cell.config['why'][key]}")
    for key, d in cell.config.get("departures", {}).items():
        ctx.log(f"departure: {name} {key} published "
                f"{cell.config.get(key)!r}, run {d['as_run']!r}: {d['why']}")
    kind = importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")
    run, readings = kind.run(ctx, cell)
    checks = {name: {"value": readings.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    metrics = {}
    for m in (cell.per_layer if ctx.trace else cell.end_to_end):
        value = load_reader(ctx.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(ctx, cell.chips, run.memory_peak_bytes)
    line = {"correct": within(checks), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def now() -> float:
    return time.perf_counter()
