"""Serving example on the PyTorch/CUDA port (``repro_torch``): batched
generation + KV-cache pages as objects + storage-side analytics over the
request log.

    PYTHONPATH=src python examples/serve_pushdown_torch.py               # on the card
    PYTHONPATH=src python examples/serve_pushdown_torch.py --device cpu

Session state (the decode KV cache) is parked to and revived from the
same object store that holds the training data, bit-exact, and the
request log is a mapped dataset whose aggregations run storage-side
(its bitpack columns decoded by the CUDA kernel on the card).  The model
is yi_9b's smoke config with random weights from a ``torch.Generator``
seeded with ``--seed``.  ``--device cuda`` needs a card and raises
without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.base import get_config
from repro_torch.core import (Column, GlobalVOL, LogicalDataset,
                              PartitionPolicy, make_store)
from repro_torch.core import format as fmt
from repro_torch.core import objclass as oc
from repro_torch.models.archs import build_model
from repro_torch.serve.engine import Request, ServeEngine


def use_device(name: str) -> torch.device:
    """The device an example runs on, with the store's bitpack decode to
    match: the CUDA kernel on a card (raises without one), the kernel's
    plain version on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        fmt.set_bitunpack_backend("device")
    else:
        fmt.set_bitunpack_backend("plain")
    return dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    backend = fmt.get_bitunpack_backend()
    try:
        dev = use_device(args.device)
        store = make_store(6, replicas=2)
        try:
            return _run(dev, store, args.seed)
        finally:
            store.close()
    finally:
        fmt.set_bitunpack_backend(backend)


def _run(dev: torch.device, store, seed: int) -> dict:
    vol = GlobalVOL(store)

    # -- a small model serving batched requests ---------------------------
    cfg = get_config("yi_9b", smoke=True)
    model = build_model(cfg, remat="none", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    engine = ServeEngine(model, max_seq=128, store=store)

    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size,
                                        rng.integers(4, 24)).astype(np.int32),
                    max_new=12) for _ in range(8)]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    t0 = time.perf_counter()
    comps = engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(c.steps for c in comps)
    assert total_new == 8 * 12, [c.steps for c in comps]
    print(f"served {len(reqs)} requests, {total_new} tokens in "
          f"{dt * 1e3:.0f} ms ({total_new / dt:.1f} tok/s on {where})")

    # -- park the batch's KV cache as objects, revive it ------------------
    engine.park_session("batch-0")
    kv_objects = store.list_objects("kv/")
    cache = engine.resume_session("batch-0", batch=len(reqs))
    parked = pytree.flatten_with_keys(engine._last_cache)
    revived = pytree.flatten_with_keys(cache)
    ok = [k for k, _ in parked] == [k for k, _ in revived] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(parked, revived))
    print(f"KV cache parked as {len(kv_objects)} objects and revived "
          f"bit-exact: {ok}")
    assert ok, "KV cache must revive bit-exact"

    # -- request log as a mapped dataset, analytics pushed down -----------
    n = 50_000
    log = LogicalDataset(
        "reqlog",
        (Column("latency_ms", "float32"), Column("tokens_out", "int32"),
         Column("model_id", "int32")),
        n_rows=n, unit_rows=1024)
    omap = vol.create(log, PartitionPolicy(target_object_bytes=256 << 10))
    latency = rng.gamma(3, 12, n).astype(np.float32)
    vol.write(omap, {
        "latency_ms": latency,
        "tokens_out": rng.integers(1, 512, n).astype(np.int32),
        "model_id": rng.integers(0, 4, n).astype(np.int32),
    })
    p50, st = vol.query(omap, [oc.op("median", col="latency_ms")],
                        allow_approx=True)
    slow, _ = vol.query(omap, [
        oc.op("filter", col="latency_ms", cmp=">", value=100.0),
        oc.op("agg", col="tokens_out", fn="count")])
    assert int(slow) == int((latency > 100.0).sum())
    print(f"request-log analytics storage-side: p50 latency ~{p50:.1f} ms, "
          f"{int(slow)} slow requests; {st['client_rx']} B moved to client")
    return {"device": str(dev), "requests": len(reqs), "tokens": total_new,
            "serve_s": dt, "tokens_per_s": total_new / dt,
            "kv_objects": len(kv_objects), "p50_ms": float(p50),
            "slow": int(slow)}


if __name__ == "__main__":
    main()
