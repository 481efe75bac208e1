"""How far the reference's own sharded train step moves with XLA's CPU
threading: the spread a port's sharded step can be held to.

Runs ``repro``'s ``make_train_step`` twice for a smoke model under
``MeshRules(strategy)`` on a 4-device CPU mesh, jitted with the
shardings of ``launch/dryrun.py::resolve_tree``, once with XLA's CPU
client single-threaded and once with its default threading (each in its
own subprocess, since the flags are read when the backend starts), two
steps at lr 1e-3 from ``PRNGKey(1)`` on ``make_batch(cfg, 4, 32, seed=20
+ i)``, as ``tests/test_torch_fsdp.py`` runs it.  Prints each run's grad
norms and the largest difference between the runs: for the moments as a
fraction of each leaf's largest entry, for the params in absolute terms
and as the share of a leaf's entries outside rtol 1e-5 / atol 1e-4.

Run from the root of a checkout:
  PYTHONPATH=src python scripts/fsdp_spread.py [arch] [strategy] [head_tp]
(default zamba2_2p7b fsdp_dp on (pod 2, data 1, model 2) with the
reference's HEAD_TP "padded"; "head_dim" flips it in the subprocesses;
~1 min on the CPU)
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ONE = ("--xla_force_host_platform_device_count=4 "
       "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
MANY = "--xla_force_host_platform_device_count=4"

RUN = """
import sys
import numpy as np, jax
from jax.sharding import Mesh
jax.devices()
from repro.launch.dryrun import resolve_tree    # after the backend starts
from repro.configs import base
from repro.distributed import sharding as shd
from repro.models import attention, inputs
from repro.models.archs import build_model
from repro.train import optimizer as opt, steps
arch, strategy, out, attention.HEAD_TP = sys.argv[1:5]
cfg = base.get_config(arch, smoke=True)
model = build_model(cfg, remat="full")
state = jax.jit(lambda k: steps.init_train_state(model, k))(
    jax.random.PRNGKey(1))
shapes, specs = steps.abstract_train_state(model, cfg.opt_dtype)
step = steps.make_train_step(model, opt.OptConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=10))
mesh = Mesh(np.array(jax.devices()).reshape(2, 1, 2),
            ("pod", "data", "model"))
rules = shd.MeshRules(mesh, strategy=strategy)
bspecs = inputs.train_input_specs(cfg, base.ShapeSpec("t", 32, 4,
                                                      "train"))[1]
in_sh = (resolve_tree(rules, specs, shapes), resolve_tree(rules, bspecs))
fn = jax.jit(step, in_shardings=in_sh, out_shardings=(in_sh[0], None))
state = jax.device_put(state, in_sh[0])
norms = []
with shd.use_rules(rules):
    for i in range(2):
        state, m = fn(state, inputs.make_batch(cfg, 4, 32, seed=20 + i))
        norms.append(float(m["grad_norm"]))
leaves = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}
np.savez(out, norms=np.array(norms), **leaves)
"""


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "zamba2_2p7b"
    strategy = sys.argv[2] if len(sys.argv) > 2 else "fsdp_dp"
    head_tp = sys.argv[3] if len(sys.argv) > 3 else "padded"
    tmp = Path(tempfile.mkdtemp())
    runs = {}
    for name, flags in (("one thread", ONE), ("default threads", MANY)):
        out = tmp / f"{len(runs)}.npz"
        env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", RUN, arch, strategy, str(out),
                        head_tp], env=env, check=True)
        runs[name] = np.load(out)
    a, b = runs.values()
    for name, z in runs.items():
        print(f"{name}: grad norms {z['norms'].tolist()}")
    moments = max((float(np.abs(a[k] - b[k]).max()
                         / (np.abs(b[k]).max() + 1e-30)), k)
                  for k in a.files if "['m']" in k or "['v']" in k)
    params = max((float(np.abs(a[k] - b[k]).max()), k)
                 for k in a.files if "['params']" in k)
    outside = max((float((~np.isclose(a[k], b[k], rtol=1e-5, atol=1e-4)
                          ).mean()), k)
                  for k in a.files if "['params']" in k and a[k].size > 64)
    print(f"moments: largest difference {moments[0]:.4g} of its leaf's "
          f"largest entry ({moments[1]})")
    print(f"params: largest difference {params[0]:.4g} ({params[1]}); "
          f"largest share of a leaf (of more than 64 entries) outside "
          f"rtol 1e-5 / atol 1e-4: {outside[0]:.4g} ({outside[1]})")


if __name__ == "__main__":
    main()
