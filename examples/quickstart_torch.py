"""Quickstart on the PyTorch/CUDA port (``repro_torch``): the paper's
system end to end, every bitpack column decoded by the CUDA kernel.

1. stand up a replicated object store (Ceph stand-in)
2. map a logical dataset onto objects through the GlobalVOL
3. run storage-side scans through the composable builder
   (filters AND together, aggregates compose, pruning happens ON the
   OSDs, table results come back as one framed response per OSD)
4. stream a windowed ingest: encode overlaps the NIC, replicas chain
5. survive failures: fail-stop OSD loss, injected bit rot (digest
   verify + scrub/heal), torn writes, and transient gray failures
   (bounded-backoff retries; loud DataLossError when data is truly gone)
6. serve it hot: OSD result caches + single-flight sessions
7. train a tiny LM whose data path IS that object store (packed token
   words unpacked on the model's device)
8. slice an N-d array: numpy-style hyperslab selections resolved ON
   the OSDs (chunked dataspaces, per-chunk zone-map pruning — wire
   bytes track the selection, not the array)
9. keep the cluster healthy: the maintenance daemons under live reads
10. verify the invariants: the objclass registry pass

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device cuda`` needs a card and raises without one; ``--device cpu``
decodes with the kernel's plain PyTorch version and trains on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch.analysis.registry import check_registry
from repro_torch.configs.base import get_config
from repro_torch.core import (Cmp, Column, Dataspace, FaultInjector,
                              GlobalVOL, LogicalDataset, MaintenancePlane,
                              PartitionPolicy, RowRange, ScanSession,
                              SkyhookDriver, make_store)
from repro_torch.core import format as fmt
from repro_torch.core.objclass import registered_ops
from repro_torch.data.corpus import CorpusSpec, build_corpus
from repro_torch.data.pipeline import ObjectDataLoader
from repro_torch.models.archs import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

WAIT_S = 120.0      # a maintenance daemon that has not acted by then failed


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


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"maintenance: {what} within {WAIT_S} s")
        time.sleep(0.01)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backend = fmt.get_bitunpack_backend()
    try:
        return _run(use_device(args.device))
    finally:
        fmt.set_bitunpack_backend(backend)


def _run(dev: torch.device) -> dict:
    with contextlib.ExitStack() as stores:
        return _sections(dev, lambda *a, **k: stores.enter_context(
            contextlib.closing(make_store(*a, **k))))


def _sections(dev: torch.device, new_store) -> dict:
    out: dict = {"device": str(dev)}
    rng = np.random.default_rng(0)

    # -- 1. an 8-OSD cluster, 3-way replication ------------------------
    store = new_store(8, replicas=3)
    vol = GlobalVOL(store)

    # -- 2. map a dataset to objects -------------------------------------
    ds = LogicalDataset(
        "sensors",
        (Column("temp", "float32"), Column("station", "int32")),
        n_rows=100_000, unit_rows=512)
    omap = vol.create(ds, PartitionPolicy(target_object_bytes=64 << 10))
    temp = rng.normal(15, 8, ds.n_rows).astype(np.float32)
    station = rng.integers(0, 50, ds.n_rows).astype(np.int32)
    vol.write(omap, {"temp": temp, "station": station})
    print(f"mapped {ds.n_rows} rows -> {omap.n_objects} objects on "
          f"{len(store.cluster.osds)} OSDs")

    # -- 3. composable pushdown scans ------------------------------------
    stats_hot, stats = (vol.scan("sensors")
                        .filter("station", "==", 7)
                        .agg("mean", "temp").agg("count", "temp")
                        .execute())
    assert stats_hot["count(temp)"] == (station == 7).sum()
    print(f"mean(temp | station==7) = {stats_hot['mean(temp)']:.3f} over "
          f"{stats_hot['count(temp)']:.0f} rows  "
          f"[{stats['client_rx']} B moved, {stats['local_bytes']} B "
          f"scanned storage-side, {stats['exec_class']}, zero zone-map "
          f"round trips ({stats['xattr_ops']})]")

    cold, stats = (vol.scan("sensors").filter("temp", "<", -20)
                   .project("temp", "station").execute())
    print(f"filter→project: {stats['result_rows']} matching rows back in "
          f"{stats['rx_frames']} framed responses "
          f"({stats['objects_pruned']} objects pruned ON their OSDs)")

    drv = SkyhookDriver(vol, n_workers=4)
    try:
        med, qstats = drv.execute(drv.scan("sensors")
                                  .median("temp", approx=True))
    finally:
        drv.close()
    print(f"median(temp) ~= {med:.3f}  [approx sketch, "
          f"{qstats.client_rx_bytes} B moved, pushdown={qstats.pushdown}]")

    # -- 3b. expression filters + OSD-side row ranges ---------------------
    # filters are a full predicate ALGEBRA (core.expr): OR-groups,
    # IN-lists, ranges, negations, string prefixes — each OSD evaluates
    # the shipped tree with vectorized masks AND prunes with interval
    # arithmetic against its own zone maps
    extremes, stats = (vol.scan("sensors")
                       .or_(("temp", "<", -10), ("temp", ">", 40))
                       .isin("station", [7, 11, 13])
                       .project("temp", "station").execute())
    print(f"OR/IN scan: {stats['result_rows']} extreme rows from 3 "
          f"stations in {stats['rx_frames']} frames, "
          f"{stats['objects_pruned']} objects pruned ON their OSDs, "
          f"{stats['xattr_ops']} zone-map round trips")

    # .rows() ships GLOBAL rows: each OSD resolves its objects'
    # sub-ranges from their own extent xattrs at execute time
    windowed, stats = (vol.scan("sensors").rows(10_000, 60_000)
                       .filter("temp", ">", 20).agg("mean", "temp")
                       .execute())
    print(f"rows[10k:60k] mean(temp|>20) = {windowed:.2f}  "
          f"[{stats['exec_class']}, prune={stats['prune']}]")

    # -- 4. streaming pipelined ingest ------------------------------------
    # with a transport model (shared client NIC, per-OSD disks) vol.write
    # STREAMS: per-OSD sub-write groups flush as the encoder produces
    # blobs, and each replica write pipelines entry -> replica -> replica
    sim = new_store(4, replicas=3, client_bw=400 << 20, disk_bw=200 << 20)
    svol = GlobalVOL(sim)
    sds = LogicalDataset("stream_demo",
                         (Column("tokens", "int32", (64,)),),
                         n_rows=20_000, unit_rows=512)
    somap = svol.create(sds, PartitionPolicy(target_object_bytes=1 << 20))
    sim.fabric.reset()
    svol.write(somap, {"tokens": rng.integers(0, 1 << 15, (20_000, 64))
                       .astype(np.int32)}, window_bytes=256 << 10)
    f = sim.fabric
    print(f"streamed ingest: {f.ops} put requests (one per OSD) in "
          f"{f.stream_windows} windows, {f.overlap_s * 1e3:.0f}ms encode "
          f"hidden behind the NIC; chain replication: entry OSD egress "
          f"{f.entry_egress_bytes >> 20}MB of {f.replica_bytes >> 20}MB "
          f"total replica traffic")

    # -- 5. surviving failures --------------------------------------------
    # 5a. fail-stop: kill an OSD, peering re-replicates from digest-
    # verified survivors; recover() raises DataLossError on real loss
    victim = store.cluster.primary(omap.object_names()[0])
    store.fail_osd(victim)
    rec = store.recover()
    rows = vol.read(omap, RowRange(0, 5))
    assert np.array_equal(rows["temp"], temp[:5])
    print(f"killed {victim}: recovered {rec['objects_moved']} replicas, "
          f"lost {rec['objects_lost']}; reads fine: temp[:5]="
          f"{np.round(rows['temp'], 2)}")

    # 5b. gray failures: bit rot on a primary copy is caught by the
    # read's digest check, quarantined, and served from a verified replica
    hit = omap.extents[1]
    target = hit.name
    fi = FaultInjector(store)
    fi.flip_bits(target, osd_id=store.cluster.locate(target)[0], n_bits=3)
    _ = vol.read(omap, hit.rows)  # served from a verified replica
    print(f"bit rot on {target}'s primary: read stayed bit-exact, "
          f"{store.fabric.corruptions_detected} corruption detected + "
          f"quarantined")

    # scrub(): verify every copy against its digest, quarantine, heal
    # from the highest-version verified source; a second scrub is clean
    fi.tear_write(omap.object_names()[2])  # blob landed, xattrs lost
    sc = store.scrub()
    print(f"scrub: {sc['objects_scrubbed']} objects verified "
          f"({store.fabric.scrub_bytes >> 20} MB), {sc['corrupt_copies']} "
          f"corrupt/torn copies found, {sc['healed_copies']} healed "
          f"through the chain; second scrub finds "
          f"{store.scrub()['corrupt_copies']}")

    # 5c. transient faults are retried with bounded exponential backoff
    fi.transient_failures(store.cluster.up_osds[0], 2)
    n_all, _ = vol.scan("sensors").agg("count", "temp").execute()
    assert n_all == ds.n_rows
    print(f"transient faults: scan retried ({store.fabric.retries} "
          f"retries) and still counted {n_all:.0f} rows")

    # -- 6. serving hot data: OSD caches + single-flight sessions ---------
    hot = new_store(4, replicas=2, scan_bw=200 << 20, cache_bytes=32 << 20)
    hvol = GlobalVOL(hot)
    hds = LogicalDataset("hotset", (Column("temp", "float64"),
                                    Column("station", "int32")),
                         n_rows=40_000, unit_rows=512)
    homap = hvol.create(hds, PartitionPolicy(target_object_bytes=128 << 10))
    hvol.write(homap, {"temp": rng.normal(15.0, 8.0, 40_000),
                       "station": rng.integers(0, 500, 40_000)
                       .astype(np.int32)})
    q = hvol.scan("hotset").filter("station", "<", 100).project("temp")
    q.execute()                     # cold: every OSD decodes from device
    b0, w0 = hot.fabric.local_bytes, hot.fabric.queue_wait_s
    q.execute()                     # warm: served from the OSD caches
    print(f"hot repeat: {hot.fabric.cache_hits} cache hits, "
          f"{hot.fabric.local_bytes - b0} new bytes decoded, "
          f"{(hot.fabric.queue_wait_s - w0) * 1e3:.1f}ms queue wait — "
          f"hits skip the service queue entirely")

    # a ScanSession single-flights identical concurrent scans
    sess = ScanSession(hvol, window_s=0.02)
    agg = hvol.scan("hotset").filter("temp", ">", 20.0).agg("count", "temp")
    ops0 = hot.fabric.ops
    clients = [threading.Thread(target=sess.execute, args=(agg,))
               for _ in range(8)]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    print(f"single-flight: 8 identical concurrent scans -> "
          f"{sess.stats['executed']} execution "
          f"({hot.fabric.ops - ops0} requests — one scan's worth), "
          f"{sess.stats['deduped']} served by fan-out")

    # -- 7. train a tiny LM straight off the store -------------------------
    cfg = get_config("yi_9b", smoke=True)
    build_corpus(vol, CorpusSpec(n_seqs=256, seq_len=128,
                                 vocab_size=cfg.vocab_size))
    model = build_model(cfg, remat="none", device=dev)
    # window_steps=2: the loader fetches two steps' rows in one
    # streaming gather and assembles each batch as ITS frames land
    loader = ObjectDataLoader(vol, "corpus", global_batch=8, packed=True,
                              window_steps=2)
    trainer = Trainer(model, loader, store, opt=OptConfig(lr=1e-3),
                      cfg=TrainerConfig(total_steps=20, ckpt_every=10,
                                        log_every=5, packed_ingest=True))
    try:
        trainer.run()
    finally:
        loader.close()
    losses = [h["loss"] for h in trainer.history]
    assert all(np.isfinite(losses)), losses
    out["loss_first"], out["loss_last"] = losses[0], losses[-1]
    print(f"trained 20 steps off the object store on {dev} "
          f"(loss {losses[0]:.2f} -> {losses[-1]:.2f}); checkpoints are "
          f"objects too: {len(store.list_objects('ckpt/'))} stored")

    # -- 8. N-d arrays: hyperslab selection pushdown -----------------------
    cube = Dataspace(name="cube", shape=(64, 64, 32), dtype="float64",
                     chunk=(16, 16, 8))
    field = rng.uniform(0.0, 1.0, cube.shape)
    field[:16, :16, :8] += 100.0                      # one hot corner
    cmap = vol.create_array(cube, PartitionPolicy(
        target_object_bytes=256 << 10))
    vol.write_array(cmap, field)
    view = vol.array("cube")

    store.fabric.reset()
    sub = view[8:56:2, ::4, 5]                        # strided 2-d slice
    assert np.array_equal(sub, field[8:56:2, ::4, 5])
    print(f"hyperslab [8:56:2, ::4, 5]: {sub.size} cells in "
          f"{store.fabric.rx_frames} framed responses, "
          f"{store.fabric.client_rx} B on the wire "
          f"(the full array is {field.nbytes} B)")

    store.fabric.reset()
    view.sel(np.s_[:, :, :], where=Cmp("data", ">", 50.0))
    print(f"where data>50: {store.fabric.chunks_pruned} cold chunks pruned "
          f"ON the OSDs from per-chunk zone maps "
          f"({store.fabric.xattr_ops} client zone-map round trips)")

    # -- 9. keeping the cluster healthy ------------------------------------
    # a continuous scrub walker, a small-object compactor, a live
    # rebalancer and versioned GC run WHILE the serve plane answers
    stream = LogicalDataset("stream", (Column("v", "float64"),), 4096, 32)
    smap = vol.create(stream, PartitionPolicy(target_object_bytes=32 * 8))
    svals = rng.normal(size=4096)
    vol.write(smap, {"v": svals})            # 1 tiny object per append
    n_small = smap.n_objects

    plane = MaintenancePlane(
        store, scrub_rate_bytes_s=512e6,     # trickle, don't burst
        compact_policy=PartitionPolicy(target_object_bytes=48 << 10),
        compact_datasets=["stream"], gc_retention_s=0.1)
    plane.start()                            # all four daemons
    try:
        plane.confirm_gc()                   # operator signs off on GC
        prev = -1
        while plane.compact_runs != prev:    # let compaction settle
            prev = plane.compact_runs
            time.sleep(0.05)
        fi.flip_bits(vol.open("stream").object_names()[0])  # rot a copy
        _wait(lambda: plane.scrub_corrupt > 0,
              "the walker found no rotten copy")
        live = vol.read(vol.open("stream"), RowRange(0, 4096))
        assert np.array_equal(live["v"], svals), \
            "maintenance must be invisible"
        time.sleep(0.15)                     # retention window passes
        plane.gc_step()
    finally:
        plane.stop()
    print(f"maintenance plane: compacted {n_small} tiny objects -> "
          f"{vol.open('stream').n_objects}, walker detected+healed "
          f"{plane.scrub_corrupt} rotten copy, GC reclaimed "
          f"{store.fabric.gc_objects} retired objects "
          f"({store.fabric.gc_bytes >> 10} KB) — live reads stayed "
          f"bit-exact")

    # -- 10. verifying the invariants --------------------------------------
    # the static linter and the lock-order harness run from the shell:
    #
    #   PYTHONPATH=src python -m repro_torch.analysis
    #   PYTHONPATH=src python -m pytest -p repro_torch.analysis.pytest_plugin \
    #       --lockcheck-torch tests/test_torch_planes.py
    #
    # here the registry pass runs in-process: every registered op
    # round-trips the wire and rides a merge plane or is declared not to
    assert check_registry() == [], "objclass registry contract broken"
    out["registry_ops"] = len(registered_ops())
    print(f"verification plane: registry contracts hold for "
          f"{out['registry_ops']} objclass ops (run `python -m "
          f"repro_torch.analysis` for the full linter)")
    return out


if __name__ == "__main__":
    main()
