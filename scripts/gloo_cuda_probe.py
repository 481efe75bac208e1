"""Which ``torch.distributed`` collectives the gloo backend runs on CUDA
tensors, with two ranks on one card (NCCL refuses two ranks on one
device).  Each collective the port's multi-device path calls is tried
once per dtype and checked against the expected sum or concatenation;
the script prints one JSON object, ``{"collective dtype": "ok" | the
error}``.  Needs a CUDA device.

Run from the root of a checkout:  python3 scripts/gloo_cuda_probe.py
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.int32, torch.float32, torch.bfloat16)


def _try(out: dict, name: str, fn) -> None:
    try:
        fn()
        out[name] = "ok"
    except Exception as exc:      # the probe reports, it does not stop
        out[name] = f"{type(exc).__name__}: {exc}"[:300]


def _rank(rank: int, world: int, init: str, q) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    out: dict = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = {}
        _try(out, "init_device_mesh cuda", lambda: mesh.setdefault(
            "m", init_device_mesh("cuda", (world,),
                                  mesh_dim_names=("pod",))))
        group = mesh["m"].get_group("pod") if "m" in mesh else None
        dev = torch.device("cuda:0")
        for dt in DTYPES:
            name = str(dt).removeprefix("torch.")

            def all_reduce():
                x = torch.full((1 << 20,), rank + 1, dtype=dt, device=dev)
                dist.all_reduce(x, group=group)
                torch.cuda.synchronize()
                assert x.is_cuda and bool((x == 3).all()), x[:4]

            def all_gather():
                x = torch.full((1000,), rank + 1, dtype=dt, device=dev)
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x, group=group)
                torch.cuda.synchronize()
                assert all(bool((p == i + 1).all())
                           for i, p in enumerate(parts))

            def reduce_scatter():
                x = torch.arange(2 * 1000, device=dev).to(dt) * (rank + 1)
                local = torch.empty(1000, dtype=dt, device=dev)
                dist.reduce_scatter(local, list(x.chunk(world)), group=group)
                torch.cuda.synchronize()
                want = torch.arange(2 * 1000, device=dev).to(dt).chunk(
                    world)[rank] * 3
                assert torch.equal(local, want)

            _try(out, f"all_reduce {name}", all_reduce)
            _try(out, f"all_gather {name}", all_gather)
            _try(out, f"reduce_scatter {name}", reduce_scatter)
        t = torch.ones(1 << 28, dtype=torch.int32, device="cuda:0")
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        out["all_reduce int32 2^28 s"] = time.perf_counter() - t0
        q.put((rank, out))
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    q = mp.get_context("spawn").Queue()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank, args=(2, f"file://{tmp}/pg", q), nprocs=2,
                       join=False)
        got = dict(q.get(timeout=600) for _ in range(2))
        ctx.join(timeout=120)
    print(json.dumps({"torch": torch.__version__, "rank0": got[0],
                      "rank1": got[1]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
