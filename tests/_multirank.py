"""What the port's multi-rank test files share: the reference's
multi-device subprocess and the port's spawned gloo ranks.

The reference runs in a subprocess whose environment alone carries a
4-device CPU platform (``XLA_FLAGS``) with XLA's CPU client
single-threaded; it writes its outputs (``OUT``) to an ``.npz``.  The
port runs as ``WORLD`` spawned gloo ranks (``file://`` rendezvous in the
fixture's temp dir, one thread each) that write theirs.  Subprocess and
ranks share one core at a lower priority (``_quiet``); each file picks
its core (``core``, an index into the sorted affinity: the last by
default), so two multi-rank files on two xdist workers do not share
one.  The pytest
worker never joins a process group, never writes ``os.environ`` and
never imports ``repro.launch.dryrun``."""

import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
RANK_DEADLINE_S = 300.0
REF_TIMEOUT_S = 900


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _block_tree(leaves: dict) -> dict:
    """A rank's blocks, keyed by parameter name, in the reference's
    tree layout (stacked leaves stacked, ``pre_blocks`` a list): fresh
    host tensors, to hold against the reference's per-device shards."""
    from repro_torch.models import transformer as pt_tr

    sizes = pt_tr._stacks(leaves)
    items: dict = {}
    for name, t in leaves.items():
        path, index = pt_tr.reference_path(name)
        if not index:
            items[path] = t.detach().to("cpu", copy=True)
            continue
        if path not in items:
            items[path] = torch.empty((*sizes[path], *t.shape),
                                      dtype=t.dtype)
        items[path][index].copy_(t.detach())
    return pt_tr._nest(items)


def _block_state(state: dict) -> dict:
    """:func:`_block_tree` of a sharded train state's params, ``m`` and
    ``v``, and its step."""
    opt = state["opt"]
    return {"params": _block_tree(state["params"]),
            "opt": {"m": _block_tree(opt["m"]), "v": _block_tree(opt["v"]),
                    "step": opt["step"].detach().to("cpu", copy=True)}}


def _spec_leaves(tree, path=""):
    """(key, spec tuple) of a spec tree of dicts and lists, keys spelled
    as ``jax.tree_util.keystr`` and ``pytree`` spell them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}[{i}]")
    else:
        yield path, tuple(tree)


def _unflatten(flat: dict) -> dict:
    """{"['a']['b']": leaf} -> {"a": {"b": leaf}}; dicts whose keys are
    all positions become lists."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
                 for m in re.finditer(r"\['([^']*)'\]|\[(\d+)\]", key)]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _coord(c) -> str:
    return ",".join(str(int(i)) for i in c)


class _NamedMesh:
    """An object that names its axes and sizes, and one coordinate; its
    groups are their axis names (no process group is made)."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord

    def get_group(self, axis):
        return axis


def _built(cfg, head_tp: str, device: str = "cpu", **kw):
    """The port's model of ``cfg`` built under ``attention.HEAD_TP =
    head_tp``, which fixes its specs; the flag is restored."""
    from repro_torch.models import attention
    from repro_torch.models.archs import build_model

    attention.HEAD_TP = head_tp
    try:
        return build_model(cfg, device=device, **kw)
    finally:
        attention.HEAD_TP = "padded"


# ------------------------------------------- the reference's subprocesses
PRELUDE = textwrap.dedent("""
    import os, sys
    _cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {_cores[CORE % len(_cores)]})
    os.nice(10)
    from pathlib import Path
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    TMP = Path(sys.argv[1])
    OUT = {}

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

    def coord(mesh, device):
        return ",".join(str(int(i)) for i in
                        np.argwhere(mesh.devices == device)[0])

    def keyed(tree):
        return {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, P))[0]}

    def host(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
""")


def _reference(prog: str, tmp: Path, core: int = -1, devices: int = WORLD,
               **consts) -> dict:
    """Run ``prog`` in a subprocess on a CPU platform of ``devices``
    devices (4 by default), on ``core``; returns the ``.npz`` it writes.
    Only the subprocess's environment carries the flags."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
               if p),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices} "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    code = (f"CORE = {core}\n" + PRELUDE + head + textwrap.dedent(prog)
            + '\nnp.savez(TMP / "ref.npz", **OUT)\n')
    out = subprocess.run([sys.executable, "-c", code, str(tmp)], env=env,
                         capture_output=True, text=True,
                         timeout=REF_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-6000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


# ------------------------------------------------------ the port's ranks
def _quiet(core: int = -1) -> None:
    """Keep this process to one core, the same for every reference
    subprocess and rank of a file (they run one group at a time), at a
    lower priority: the suite's other workers, timing-sensitive tests
    among them, keep the rest of the machine."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[core % len(cores)]})
    os.nice(10)


def _rank_main(rank, world, init, tmp, job, core):
    import torch.distributed as dist
    _quiet(core)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = job(rank, Path(tmp))
        np.savez(Path(tmp) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _ranks(job, tmp: Path, core: int = -1) -> list[dict]:
    """Spawn ``WORLD`` gloo ranks on ``core`` running ``job(rank, tmp)
    -> {name: array}`` (a function at the top level of a test module);
    a hung or failed rank fails the fixture within
    ``RANK_DEADLINE_S``."""
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(WORLD, f"file://{tmp}/pg", str(tmp), job, core),
        nprocs=WORLD, join=False)
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):   # re-raises a failed rank's error
            if time.monotonic() > deadline:
                raise AssertionError(f"{job.__name__}: a gloo rank did not "
                                     f"finish in {RANK_DEADLINE_S:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append(dict(z))
    return out
