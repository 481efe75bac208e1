"""Production mesh construction, the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches
no process group.  Production target: pods of 256 devices arranged
(data=16, model=16); the multi-pod mesh adds a leading "pod" axis of 2
(512 devices).  A mesh is a ``torch.distributed`` ``DeviceMesh`` over
the ranks of the default process group, which the caller initialises
(``init_process_group`` with its address, world size and rank).
"""

from __future__ import annotations

import math


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``, over ranks 0..n-1 of the process group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, the process group's "
            f"world size is {world}; start {n} ranks and call "
            "torch.distributed.init_process_group in each first")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh over the whole process group (tests pass
    ``device_type="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
