"""The store's client and maintenance planes on ``repro`` and on
``repro_torch``: fault injection, scan sessions, the Skyhook driver, the
maintenance daemons and elastic resize.

Each flow runs, step for step, on both packages over the same data
(made from a seed with numpy).  Results, the stores' contents (object
names, blob digests, xattrs, quarantines), the fabric's integer
counters and maintenance ``run_once`` outputs must be exactly equal;
wall-clock fields (``*_s``) are left out.  Each flow also holds the
assertions of the reference's own test of it.  The port decodes with
its plain bitunpack, the reference with numpy.
"""

import dataclasses
import importlib
import threading
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import format as ref_fmt
from repro_torch.core import format as pt_fmt
from repro_torch.kernels import bitunpack as bu


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(root=root, core=mod("core"),
                           oc=mod("core.objclass"), fmt=mod("core.format"),
                           part=mod("core.partition"),
                           placement=mod("core.placement"),
                           scan=mod("core.scan"),
                           elastic=mod("distributed.elastic"))


REF, PT = _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(autouse=True)
def cpu_decode():
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


# ------------------------------------------------------------ helpers
def _same(a, b, path="$"):
    """Deep equality: arrays by dtype and value, floats exactly (NaN
    equal to NaN), containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _fab(store) -> dict:
    return {k: v for k, v in store.fabric.snapshot().items()
            if not k.endswith("_s")}


def _state(store) -> dict:
    """Every OSD's objects (crc32 of each blob), xattrs and quarantined
    names — what both packages must leave on disk alike."""
    out = {}
    for osd_id in sorted(store.osds):
        osd = store.osds[osd_id]
        with osd.lock:
            out[osd_id] = {
                "data": {n: zlib.crc32(b) for n, b in osd.data.items()},
                "xattrs": {n: dict(x) for n, x in osd.xattrs.items()},
                "quarantine": sorted(osd.quarantine)}
    return out


def _stats(s) -> dict:
    d = s if isinstance(s, dict) else dataclasses.asdict(s)
    return {k: v for k, v in d.items() if not k.endswith("_s")}


def _both(flow, *args, **kw):
    """Run ``flow`` on both packages; their records must be equal.
    Returns the port's record."""
    ref = flow(REF, *args, **kw)
    pt = flow(PT, *args, **kw)
    _same(ref, pt)
    return pt


def _world(P, n=4000, n_osds=6, replicas=3, seed=0, obj_kb=8, name="t",
           **store_kw):
    """The self-heal suites' world: ``x`` float64, ``y`` int32 in
    [0, 1000) (a bitpack column), objects of about ``obj_kb`` KiB."""
    c = P.core
    rng = np.random.default_rng(seed)
    ds = c.LogicalDataset(
        name, (c.Column("x", "float64"), c.Column("y", "int32")), n, 64)
    store = c.make_store(n_osds, replicas=replicas, **store_kw)
    vol = c.GlobalVOL(store)
    omap = vol.create(ds, c.PartitionPolicy(
        target_object_bytes=obj_kb << 10, max_object_bytes=obj_kb << 13))
    table = {"x": rng.normal(size=n),
             "y": rng.integers(0, 1000, n).astype(np.int32)}
    vol.write(omap, table)
    return store, vol, omap, table


def _append_world(P, n=2048, unit_rows=32, n_osds=6, replicas=3, seed=1,
                  name="ck"):
    """One tiny object per unit (the ckpt/kvcache append pattern), with
    a bitpack column ``k`` beside the float64 ``v``."""
    c = P.core
    rng = np.random.default_rng(seed)
    ds = c.LogicalDataset(name, (c.Column("v", "float64"),
                                 c.Column("k", "int32")), n, unit_rows)
    store = c.make_store(n_osds, replicas=replicas)
    vol = c.GlobalVOL(store)
    omap = vol.create(ds, c.PartitionPolicy(
        target_object_bytes=unit_rows * 12, max_object_bytes=1 << 20))
    table = {"v": rng.normal(size=n),
             "k": rng.integers(0, 100, n).astype(np.int32)}
    vol.write(omap, table)
    return store, vol, omap, table


def _verify_all(P, store, name):
    for osd_id in store.cluster.locate(name):
        osd = store.osds[osd_id]
        assert name in osd.data, (name, osd_id)
        x = osd.xattrs.get(name) or {}
        assert P.fmt.content_digest(osd.data[name]) == int(x["digest"])


# =================================================================== faults
@pytest.mark.parametrize("n_bits", [1, 3, 8, 40])
def test_flip_bits_hits_the_same_bytes(n_bits):
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[1]
        acting = store.cluster.locate(name)
        hit = fi.flip_bits(name, osd_id=acting[1], n_bits=n_bits)
        default_hit = fi.flip_bits(omap.object_names()[2], n_bits=n_bits)
        blob = store.osds[hit].data[name]
        return {"hit": hit, "default_hit": default_hit,
                "blob": np.frombuffer(blob, np.uint8).copy(),
                "injected": [dataclasses.astuple(i) for i in fi.injected],
                "state": _state(store)}
    _both(flow)


def test_corrupt_primary_read_fails_over_and_is_counted():
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[0]
        prim = store.cluster.locate(name)[0]
        fi.flip_bits(name, osd_id=prim, n_bits=5)
        out = vol.read(omap, P.core.RowRange(0, 1000))
        assert np.array_equal(out["x"], table["x"][:1000])
        assert store.fabric.corruptions_detected == 1
        assert name in store.osds[prim].quarantine
        assert name not in store.osds[prim].data
        return {"out": out, "fabric": _fab(store), "state": _state(store)}
    _both(flow)


def test_all_replicas_corrupt_is_loud_data_loss():
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[0]
        for osd_id in list(store.cluster.locate(name)):
            fi.flip_bits(name, osd_id=osd_id)
        with pytest.raises(P.core.DataLossError) as ei:
            store.get(name)
        assert name in ei.value.objects
        return {"objects": ei.value.objects, "census": ei.value.census,
                "fabric": _fab(store)}
    _both(flow)


def test_scans_bit_exact_under_replica_corruption():
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        for name in omap.object_names()[::2]:
            fi.flip_bits(name, osd_id=store.cluster.locate(name)[0])
        r, stats = vol.query(omap, [P.oc.op("agg", col="y", fn="count")])
        assert r == float(len(table["y"]))
        out = vol.read(omap, P.core.RowRange(0, len(table["y"])))
        assert np.array_equal(out["y"], table["y"])
        assert np.array_equal(out["x"], table["x"])
        assert store.fabric.corruptions_detected >= len(fi.injected)
        return {"r": r, "stats": _stats(stats), "out": out,
                "fabric": _fab(store), "state": _state(store)}
    _both(flow)


@pytest.mark.parametrize("case", ["retried", "exhausted", "slow"])
def test_gray_failures_retry_fail_over_and_stay_exact(case):
    def flow(P):
        c = P.core
        retry = {"retried": c.RetryPolicy(attempts=4, base_s=0.0),
                 "exhausted": c.RetryPolicy(attempts=1), "slow": None}[case]
        store, vol, omap, table = _world(P, retry=retry)
        fi = c.FaultInjector(store)
        name = omap.object_names()[0]
        victim = store.cluster.primary(name)
        if case == "retried":
            fi.transient_failures(victim, 2)
            r, _ = vol.query(omap, [P.oc.op("agg", col="y", fn="count")])
            assert r == float(len(table["y"]))
            assert store.fabric.retries >= 2
        elif case == "exhausted":
            fi.transient_failures(store.cluster.locate(name)[0], 50)
            r = store.get(name)
            assert store.fabric.retries == 0
        else:
            fi.slow(victim, 0.002)
            r, _ = vol.query(omap, [P.oc.op("agg", col="x", fn="sum")])
            assert r == pytest.approx(table["x"].sum(), rel=1e-12)
        return {"r": r, "fabric": _fab(store)}
    _both(flow)


@pytest.mark.parametrize("case", ["bitrot", "torn", "no_heal"])
def test_scrub_detects_quarantines_and_heals(case):
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[0 if case != "torn" else 1]
        if case == "torn":
            hit = fi.tear_write(name)
        else:
            hit = fi.flip_bits(name, n_bits=3)
        first = store.scrub(heal=case != "no_heal")
        assert first["corrupt_copies"] == 1
        assert name in store.osds[hit].quarantine
        second = store.scrub()
        if case == "no_heal":
            assert first["healed_copies"] == 0
            assert second["healed_copies"] >= 1
        else:
            assert first["healed_copies"] >= 1
            assert second["corrupt_copies"] == 0
            assert second["healed_copies"] == 0
        _verify_all(P, store, name)
        return {"hit": hit, "first": first, "second": second,
                "fabric": _fab(store), "state": _state(store)}
    _both(flow)


def test_legacy_undigested_objects_are_reported_not_touched():
    def flow(P):
        store = P.core.make_store(4, replicas=2)
        for osd_id in store.cluster.locate("old"):
            store.osds[osd_id].put("old", b"legacy bytes", {"version": 1})
        stats = store.scrub()
        assert "old" in stats["undigested"] and stats["corrupt_copies"] == 0
        assert store.get("old") == b"legacy bytes"
        return {"stats": stats, "fabric": _fab(store)}
    _both(flow)


def test_recover_never_propagates_a_corrupt_replica():
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[0]
        acting = store.cluster.locate(name)
        fi.flip_bits(name, osd_id=acting[0])
        store.fail_osd(acting[1])
        rec = store.recover()
        _verify_all(P, store, name)
        out = vol.read(omap, P.core.RowRange(0, 500))
        assert np.array_equal(out["x"], table["x"][:500])
        return {"rec": rec, "out": out, "fabric": _fab(store),
                "state": _state(store)}
    _both(flow)


def test_recover_raises_dataloss_with_names_and_opt_out():
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        name = omap.object_names()[0]
        for osd_id in list(store.cluster.locate(name)):
            fi.flip_bits(name, osd_id=osd_id)
        with pytest.raises(P.core.DataLossError) as ei:
            store.recover()
        rec = store.recover(allow_loss=True)
        assert rec["objects_lost"] == 1 and name in rec["lost"]
        return {"objects": ei.value.objects, "census": ei.value.census,
                "rec": rec, "fabric": _fab(store)}
    _both(flow)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_campaign_draws_the_same_targets(seed):
    """``campaign`` draws from ``random.Random(seed)`` in the reference's
    order: the same (kind, object, OSD) injections, the same damage,
    and scrub finds and heals exactly those copies."""
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        placed = fi.campaign(omap.object_names(), flips=8, torn=2,
                             seed=seed)
        assert len(placed) == 10
        assert len({(i.name, i.osd_id) for i in placed}) == 10
        damaged = _state(store)
        first = store.scrub()
        assert first["corrupt_copies"] == 10
        assert store.fabric.corruptions_detected == fi.corruptions_injected
        second = store.scrub()
        assert second["corrupt_copies"] == 0
        assert second["healed_copies"] == 0
        return {"placed": [dataclasses.astuple(i) for i in placed],
                "damaged": damaged, "first": first,
                "fabric": _fab(store), "state": _state(store)}
    _both(flow)


@given(st.lists(st.tuples(st.integers(0, 7), st.integers(0, 2)),
                min_size=1, max_size=10, unique=True))
@settings(max_examples=15, deadline=None)
def test_scrub_converges_under_random_distinct_corruption(pattern):
    """Property: corrupt any set of DISTINCT copies that leaves every
    object one copy to heal from; one healing scrub finds exactly those
    copies and a second finds nothing — on both packages alike."""
    def flow(P):
        store, vol, omap, table = _world(P)
        fi = P.core.FaultInjector(store)
        names = omap.object_names()
        copies: dict[str, set] = {}
        for obj_i, rep_i in pattern:
            name = names[obj_i % len(names)]
            acting = store.cluster.locate(name)
            hit = copies.setdefault(name, set())
            if len(hit) < len(acting) - 1:
                hit.add(acting[rep_i % len(acting)])
        for name in sorted(copies):
            for osd_id in sorted(copies[name]):
                fi.flip_bits(name, osd_id=osd_id)
        first = store.scrub()
        assert first["corrupt_copies"] == sum(map(len, copies.values()))
        second = store.scrub()
        assert second["corrupt_copies"] == 0
        assert second["healed_copies"] == 0
        for name in names:
            _verify_all(P, store, name)
        return {"first": first, "fabric": _fab(store),
                "state": _state(store)}
    _both(flow)


def test_randomized_fault_campaign_live_scans_stay_bit_exact():
    """Bit flips, transient failures, a slow OSD and a torn write at
    once: live scans stay exact, scrub finds every injected copy."""
    def flow(P):
        c = P.core
        store, vol, omap, table = _world(
            P, n=6000, retry=c.RetryPolicy(attempts=4, base_s=0.0))
        fi = c.FaultInjector(store)
        rng = np.random.default_rng(42)
        names = omap.object_names()
        victims = rng.choice(len(names), size=3, replace=False)
        for i in victims:
            acting = store.cluster.locate(names[i])
            fi.flip_bits(names[i],
                         osd_id=acting[int(rng.integers(len(acting)))],
                         n_bits=int(rng.integers(1, 8)))
        fi.tear_write(names[int(rng.choice(
            [i for i in range(len(names)) if i not in victims]))])
        fi.slow(store.cluster.up_osds[0], 0.001)
        for osd_id in store.cluster.up_osds[1:3]:
            fi.transient_failures(osd_id, 2)
        r, _ = vol.query(omap, [P.oc.op("agg", col="y", fn="count")])
        assert r == float(len(table["y"]))
        s, _ = (vol.scan("t").filter("y", "<", 500).agg("sum", "x")
                .execute(omap))
        assert s == pytest.approx(table["x"][table["y"] < 500].sum(),
                                  rel=1e-12)
        out = vol.read(omap, c.RowRange(100, 4100))
        assert np.array_equal(out["y"], table["y"][100:4100])
        fi.clear()
        stats = store.scrub()
        assert store.fabric.corruptions_detected == fi.corruptions_injected
        assert stats["lost"] == ()
        second = store.scrub()
        assert second["corrupt_copies"] == 0
        return {"r": r, "s": s, "out": out, "scrub": stats,
                "fabric": _fab(store), "state": _state(store)}
    _both(flow)


# ================================================================== session
def _clients(n, fn):
    """Run ``fn(i)`` on ``n`` threads released together; every thread
    must finish within 60 s."""
    bar = threading.Barrier(n)
    errors = []

    def run(i):
        try:
            bar.wait(timeout=30)
            fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_session_identity_keys_match_the_reference():
    """Flights key on ``pipeline_digest``: the same scan gives the same
    key in both packages (OSD caches key on it too)."""
    def flow(P):
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        scans = [vol.scan("t").filter("y", "<", 700).project("x"),
                 vol.scan("t").filter("y", ">=", 250).agg("sum", "x")
                 .agg("count", "x"),
                 vol.scan("t").rows(10, 900).median("x", approx=True),
                 vol.scan("t").project("y")]
        return [P.core.ScanSession._identity(s) for s in scans]
    _both(flow)


def test_single_flight_fans_one_execution_out_bit_identically():
    def flow(P):
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        session = P.core.ScanSession(vol, window_s=0.05)
        n = 6
        results = [None] * n

        def client(i):
            results[i], _ = session.execute(
                vol.scan("t").filter("y", "<", 700).project("x"))

        _clients(n, client)
        assert session.stats["executed"] == 1
        assert session.stats["deduped"] == n - 1
        for r in results:
            assert np.array_equal(r["x"], table["x"][table["y"] < 700])
            assert r["x"] is results[0]["x"]
        return {"result": results[0], "stats": session.stats,
                "fabric": _fab(store)}
    _both(flow)


def test_column_coalescing_widens_one_flight_and_slices_back():
    def flow(P):
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        session = P.core.ScanSession(vol, window_s=0.05)
        cols = ("x", "y", "x", "y")
        results = [None] * len(cols)

        def client(i):
            results[i], _ = session.execute(
                vol.scan("t").filter("y", ">=", 250).project(cols[i]))

        _clients(len(cols), client)
        assert session.stats["executed"] == 1
        assert session.stats["coalesced"] >= 1
        keep = table["y"] >= 250
        for i, c in enumerate(cols):
            assert set(results[i]) == {c}
            assert np.array_equal(results[i][c], table[c][keep])
        return {"results": results, "executed": session.stats["executed"],
                "fabric": _fab(store)}
    _both(flow)


def test_session_sequential_scans_and_errors():
    def flow(P):
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        session = P.core.ScanSession(vol)
        for _ in range(3):
            out, stats = session.execute(vol.scan("t").project("y"))
            assert np.array_equal(out["y"], table["y"])
        assert session.stats == {"admitted": 3, "executed": 3,
                                 "deduped": 0, "coalesced": 0, "solo": 0}
        seq_stats = dict(session.stats)
        session = P.core.ScanSession(vol, window_s=0.05)
        errs = [None] * 4

        def client(i):
            try:
                session.execute(vol.scan("t").filter("y", "<", 1)
                                .project("nope"))
            except Exception as e:  # noqa: BLE001 — held below
                errs[i] = e

        _clients(4, client)
        assert all(e is not None for e in errs)
        assert session.stats["executed"] == 1
        out2, _ = session.execute(vol.scan("t").project("x"))
        assert np.array_equal(out2["x"], table["x"])
        return {"out": out, "stats": _stats(stats), "seq": seq_stats,
                "error": [type(e).__name__ for e in errs],
                "fabric": _fab(store)}
    _both(flow)


def test_session_aggregate_dedup_equals_direct_scan():
    """Many clients, one filter -> agg: every result equals the direct
    scan's (the chip smoke's session phase, at test size)."""
    def flow(P):
        store, vol, omap, table = _world(P)
        session = P.core.ScanSession(vol, window_s=0.05)

        def q():
            return vol.scan("t").filter("y", "<", 500).agg("sum", "x") \
                .agg("count", "x")

        direct, _ = q().execute()
        results = [None] * 8

        def client(i):
            results[i], _ = session.execute(q())

        _clients(8, client)
        assert all(r == direct for r in results)
        assert session.stats["executed"] == 1
        assert session.stats["admitted"] == 8
        return {"direct": direct, "stats": session.stats}
    _both(flow)


# ================================================================== skyhook
def _driver_flow(P, **store_kw):
    c, sc = P.core, P.scan
    store, vol, omap, table = _world(P, n_osds=5, **store_kw)
    drv = c.SkyhookDriver(vol, n_workers=3)
    rec = {}
    try:
        q = c.Query("t", filter=("y", "<", 300), aggregate=("mean", "x"))
        for name, run in (
                ("pushdown", lambda: drv.execute(q)),
                ("client_side", lambda: drv.execute_client_side(q)),
                ("multi_filter", lambda: drv.execute(c.Query(
                    "t", filters=(("y", ">", 100), ("y", "<", 300)),
                    aggregate=("count", "x")))),
                ("impossible", lambda: drv.execute(c.Query(
                    "t", filters=(("y", ">", 100), ("y", ">", 2000)),
                    aggregate=("count", "x")))),
                ("project", lambda: drv.execute(c.Query(
                    "t", filter=("y", "<", 50), projection=("x",)))),
                ("multi_agg", lambda: drv.execute(c.Query(
                    "t", aggregate=(("sum", "x"), ("count", "y"))))),
                ("median", lambda: drv.execute(c.Query(
                    "t", aggregate=("median", "x")))),
                ("median_approx", lambda: drv.execute(c.Query(
                    "t", aggregate=("median", "x"), allow_approx=True))),
                ("scan_agg", lambda: drv.execute(
                    drv.scan("t").filter("y", "<", 500).agg("sum", "x")
                    .agg("count", "x"))),
                ("scan_project", lambda: drv.scan("t")
                 .filter("y", ">", 900).project("y", "x").execute()),
                ("scan_rows", lambda: drv.scan("t").rows(123, 3456)
                 .project("x", "y").execute())):
            before = _fab(store)
            res, stats = run()
            after = _fab(store)
            rec[name] = {"result": res, "stats": _stats(stats),
                         "fabric": {k: after[k] - before[k] for k in after}}
    finally:
        drv.close()
    r = rec
    assert r["pushdown"]["result"] == pytest.approx(
        table["x"][table["y"] < 300].mean(), rel=1e-9)
    assert r["pushdown"]["result"] == pytest.approx(
        r["client_side"]["result"], rel=1e-12)
    assert r["pushdown"]["stats"]["client_rx_bytes"] * 20 < \
        r["client_side"]["stats"]["client_rx_bytes"]
    assert r["pushdown"]["stats"]["pushdown"]
    assert not r["client_side"]["stats"]["pushdown"]
    assert r["pushdown"]["stats"]["fabric_ops"] <= len(store.cluster.up_osds)
    assert r["multi_filter"]["result"] == float(
        ((table["y"] > 100) & (table["y"] < 300)).sum())
    assert r["impossible"]["result"] == 0.0
    assert r["impossible"]["stats"]["objects_pruned"] == omap.n_objects
    assert np.array_equal(r["project"]["result"]["x"],
                          table["x"][table["y"] < 50])
    assert r["project"]["stats"]["result_rows"] == int(
        (table["y"] < 50).sum())
    assert r["median"]["result"] == float(np.median(table["x"]))
    assert r["median_approx"]["stats"]["exec_class"] == sc.EXEC_OSD_COMBINE
    assert r["scan_agg"]["result"]["count(x)"] == float(
        (table["y"] < 500).sum())
    keep = table["y"] > 900
    assert np.array_equal(r["scan_project"]["result"]["x"], table["x"][keep])
    assert np.array_equal(r["scan_rows"]["result"]["y"], table["y"][123:3456])
    return rec


@pytest.mark.parametrize("io", ["in_process", "simulated_io"])
def test_skyhook_driver_matches_reference(io):
    """Every driver entry point: results, ``QueryStats`` and the fabric
    cost of each query equal the reference's.  ``simulated_io`` models
    NIC time, so shards run on the driver's pool threads."""
    kw = {"client_bw": 20e9} if io == "simulated_io" else {}
    _both(_driver_flow, **kw)


def test_skyhook_close_ends_the_pool_threads():
    store, vol, omap, table = _world(PT, n_osds=5, client_bw=20e9)
    drv = PT.core.SkyhookDriver(vol, n_workers=3)
    res, _ = drv.execute(PT.core.Query("t", filter=("y", "<", 50),
                                       projection=("x",)))
    assert np.array_equal(res["x"], table["x"][table["y"] < 50])
    threads = list(drv._pool._threads)
    assert threads
    drv.close()
    assert not any(t.is_alive() for t in threads)
    store.close()


def test_skyhook_and_vol_execute_identical_plans():
    def flow(P):
        store, vol, omap, table = _world(P, n_osds=5)
        drv = P.core.SkyhookDriver(vol, n_workers=3)
        q = P.core.Query("t", filter=("y", "<", 300), aggregate=("mean", "x"))
        r1, s1 = drv.execute(q)
        r2, vs = vol.query(omap, q.pipeline())
        drv.close()
        assert r1 == pytest.approx(r2, rel=1e-15)
        assert (s1.exec_class, s1.prune, s1.fabric_ops, s1.rx_frames) == \
            (vs["exec_class"], vs["prune"], vs["ops"], vs["rx_frames"])
        return {"r1": r1, "r2": r2, "s1": _stats(s1), "vs": _stats(vs)}
    _both(flow)


# ============================================================== maintenance
def test_run_once_passes_match_the_reference():
    """A damaged, grown, tiny-object cluster under ``run_once``: the
    compaction outputs (names from the store's write clock), object
    maps, GC ledger, scrub and rebalance counts, and every OSD's
    contents are those of the reference after each pass."""
    def flow(P):
        store, vol, omap, table = _append_world(P)
        fi = P.core.FaultInjector(store)
        fi.campaign(omap.object_names(), flips=3, torn=1, seed=2)
        store.add_osds(["osd.x0"])
        plane = P.core.MaintenancePlane(
            store, compact_policy=P.part.PartitionPolicy(
                target_object_bytes=32 << 10, max_object_bytes=1 << 20),
            gc_retention_s=0.0, gc_confirmed=True, batch_objects=16)
        passes = []
        try:
            for _ in range(3):
                got = plane.run_once()
                with plane._lock:
                    dead = sorted(plane._dead)
                passes.append({
                    "run_once": got, "dead": dead,
                    "stats": plane.stats(), "fabric": _fab(store),
                    "objmap": store.get(P.part.objmap_key("ck")),
                    "objects": store.list_objects(),
                    "state": _state(store)})
        finally:
            plane.stop()
        first = passes[0]["run_once"]
        assert first["scrub"]["corrupt"] == 4
        assert first["compacted"] and first["gc"]["dead_reclaimed"] > 0
        assert store.fabric.corruptions_detected == fi.corruptions_injected
        assert passes[-1]["run_once"]["compacted"] == []
        fresh = vol.open("ck")
        assert fresh.n_objects * 4 <= omap.n_objects
        out = vol.read(fresh, P.core.RowRange(0, len(table["v"])))
        assert np.array_equal(out["v"], table["v"])
        assert np.array_equal(out["k"], table["k"])
        assert store.scrub()["corrupt_copies"] == 0
        return {"passes": passes, "out": out}
    _both(flow)


def test_walker_heals_and_is_idempotent():
    def flow(P):
        store, vol, omap, table = _world(P, n=4096)
        fi = P.core.FaultInjector(store)
        names = omap.object_names()
        hits = [fi.flip_bits(names[0], n_bits=3), fi.tear_write(names[1])]
        plane = P.core.MaintenancePlane(store, batch_objects=4)
        steps = []
        for _ in range(2):
            plane._scrub_cursor = ""
            while True:
                got = plane.scrub_step()
                steps.append(got)
                if not got["objects"]:
                    break
        plane.stop()
        assert plane.scrub_corrupt == 2 and plane.scrub_healed >= 2
        assert store.fabric.corruptions_detected == fi.corruptions_injected
        for name, hit in zip(names[:2], hits):
            assert name in store.osds[hit].quarantine
            _verify_all(P, store, name)
        after = store.scrub()
        assert after["corrupt_copies"] == 0 and after["healed_copies"] == 0
        return {"steps": steps, "stats": plane.stats(),
                "fabric": _fab(store), "state": _state(store)}
    _both(flow)


def test_compaction_retargets_old_plans_and_gc_collects_members():
    def flow(P):
        store, vol, omap, table = _append_world(P, n=1024)
        plane = P.core.MaintenancePlane(
            store, compact_policy=P.part.PartitionPolicy(
                target_object_bytes=32 << 10, max_object_bytes=1 << 20),
            gc_retention_s=0.0)
        old_plan = vol.scan("ck").rows(100, 900).agg("sum", "v") \
            .explain(omap)
        runs = []
        while True:
            got = plane.compact_step()
            if got is None:
                break
            runs.append(got)
        members = [m for r in runs for m in r["members"]]
        assert runs and all(store.exists(m) for m in members)
        got, _ = vol.engine.execute(old_plan)
        assert got == pytest.approx(float(table["v"][100:900].sum()),
                                    rel=1e-12)
        unconfirmed = plane.gc_step()
        assert all(store.exists(m) for m in members)
        plane.confirm_gc()
        gc = plane.gc_step()
        plane.stop()
        assert gc["dead_reclaimed"] == len(members)
        assert not any(store.exists(m) for m in members)
        fresh = vol.open("ck")
        assert fresh.version > omap.version
        out = vol.read(fresh, P.core.RowRange(0, len(table["v"])))
        assert np.array_equal(out["v"], table["v"])
        return {"runs": runs, "old_plan": got, "unconfirmed": unconfirmed,
                "gc": gc, "fabric": _fab(store), "state": _state(store),
                "out": out}
    _both(flow)


def test_rebalance_moves_to_fresh_placement_and_keeps_old_copy():
    def flow(P):
        c = P.core
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        store.add_osds([f"osd.n{i}" for i in range(3)])
        plane = c.MaintenancePlane(store, batch_objects=16)
        steps = []
        while True:
            got = plane.rebalance_step()
            steps.append(got)
            if not got["objects"]:
                break
        plane.stop()
        for name in omap.object_names():
            acting = set(store.cluster.locate(name))
            for osd_id in store.cluster.up_osds:
                assert (name in store.osds[osd_id].data) == \
                    (osd_id in acting)
        rec = store.recover()
        assert rec["objects_moved"] == 0 and rec["lost"] == ()
        # verify-before-drop: a refusing target keeps the old copy
        s2 = c.make_store(3, replicas=1, retry=c.RetryPolicy(attempts=2))
        names = [f"mv{i}" for i in range(16)]
        olds = {}
        for n in names:
            s2.put(n, b"payload" * 100)
            olds[n] = s2.cluster.primary(n)
        s2.add_osds(["osd.z0", "osd.z1", "osd.z2"])
        name = next(n for n in names if s2.cluster.primary(n) != olds[n])
        fi = c.FaultInjector(s2)
        fi.transient_failures(s2.cluster.primary(name), 1000)
        refused = s2.rebalance_object(name)
        kept = name in s2.osds[olds[name]].data
        fi.clear()
        moved = s2.rebalance_object(name)
        assert refused == 0 and kept and moved > 0
        assert name not in s2.osds[olds[name]].data
        return {"steps": steps, "rec": rec, "fabric": _fab(store),
                "state": _state(store), "moved": moved, "name": name,
                "s2": _state(s2)}
    _both(flow)


def test_gc_keeps_sole_quarantined_copy_and_purges_healed_ones():
    def flow(P):
        c = P.core
        store, vol, omap, table = _world(P, n_osds=4, replicas=2)
        fi = c.FaultInjector(store)
        name = omap.object_names()[0]
        for osd_id in list(store.cluster.locate(name)):
            fi.flip_bits(name, osd_id=osd_id)
        store.scrub(heal=False)
        plane = c.MaintenancePlane(store, gc_retention_s=0.0,
                                   gc_confirmed=True)
        sole = [plane.gc_step(), plane.gc_step()]
        plane.stop()
        assert sole[1]["quarantine_purged"] == 0
        kept = [o for o in store.cluster.up_osds
                if name in store.osds[o].quarantine]
        assert kept
        store2, vol2, omap2, _ = _world(P)
        fi2 = c.FaultInjector(store2)
        name2 = omap2.object_names()[0]
        hit = fi2.flip_bits(name2)
        store2.scrub()
        plane2 = c.MaintenancePlane(store2, gc_retention_s=0.0,
                                    gc_confirmed=True)
        purged = plane2.gc_step()
        plane2.stop()
        assert purged["quarantine_purged"] == 1
        assert name2 not in store2.osds[hit].quarantine
        _verify_all(P, store2, name2)
        return {"sole": sole, "kept": kept, "purged": purged,
                "fabric": _fab(store), "fabric2": _fab(store2)}
    _both(flow)


def _wait_for(cond, timeout_s, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def test_daemons_under_live_scans_faults_and_resize():
    """All four daemons as threads while a client scans and faults land,
    then one OSD more and a rebalance: every foreground result is exact,
    and the cluster ends compacted, healed, rebalanced and collected.
    GC's retention (0.5 s) outlasts any scan in flight."""
    c = PT.core
    store, vol, omap, table = _append_world(PT, n=2048)
    fi = c.FaultInjector(store)
    plane = c.MaintenancePlane(
        store, compact_policy=PT.part.PartitionPolicy(
            target_object_bytes=32 << 10, max_object_bytes=1 << 20),
        gc_retention_s=0.5, gc_confirmed=True, batch_objects=16,
        interval_s=0.0005)
    sel = table["k"] < 50
    want_sum, want_count = float(table["v"][sel].sum()), float(sel.sum())
    stop = threading.Event()
    results, errors = [], []

    def query():
        r, _ = (vol.scan("ck").filter("k", "<", 50).agg("sum", "v")
                .agg("count", "v").execute())
        return r["sum(v)"], r["count(v)"]

    def client():
        try:
            while not stop.is_set():
                results.append(query())
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    reader = threading.Thread(target=client)
    plane.start()
    reader.start()
    try:
        _wait_for(lambda: plane.compact_runs > 0, 30, "compaction")
        prev = -1  # let compaction settle so the campaign hits objects
        while plane.compact_runs != prev:  # that stay in the live map
            prev = plane.compact_runs
            time.sleep(0.2)
        placed = fi.campaign(vol.open("ck").object_names(), flips=3,
                             torn=1, seed=2)
        assert placed
        _wait_for(lambda: store.fabric.corruptions_detected
                  == fi.corruptions_injected, 30, "walker detection")
        _wait_for(lambda: plane.gc_reclaimed > 0, 30, "gc reclaim")
        plane.pause()
        PT.elastic.apply_storage_resize(store, add=("osd.x0",))
        plane.note_topology_change()
        while plane.rebalance_step()["objects"]:
            pass
    finally:
        stop.set()
        reader.join(timeout=60)
        plane.stop()
    assert not reader.is_alive() and errors == []
    assert results
    for got_sum, got_count in results + [query()]:
        assert got_count == want_count
        assert got_sum == pytest.approx(want_sum, rel=1e-9)
    assert plane.stats()["errors"] == []
    fresh = vol.open("ck")
    assert fresh.n_objects * 4 <= omap.n_objects
    out = vol.read(fresh, c.RowRange(0, len(table["v"])))
    assert np.array_equal(out["v"], table["v"])
    assert store.recover()["objects_moved"] == 0
    final = store.scrub()
    assert final["corrupt_copies"] == 0 and final["lost"] == ()
    store.close()


def test_walker_pause_resume_survives_topology_churn():
    c = PT.core
    store, vol, omap, table = _world(PT, n=4096)
    fi = c.FaultInjector(store)
    plane = c.MaintenancePlane(store, batch_objects=2, interval_s=0.0005)
    plane.start(daemons=("scrub",))
    try:
        _wait_for(lambda: plane.scrub_objects > 0, 10, "walker progress")
        plane.pause()
        time.sleep(0.02)
        store.fail_osd(store.cluster.up_osds[0])
        store.add_osds(["osd.new0", "osd.new1"])
        store.recover()
        name = omap.object_names()[2]
        fi.flip_bits(name, n_bits=2)
        parked = plane.scrub_objects
        time.sleep(0.02)
        assert plane.scrub_objects == parked
        assert plane.stats()["topology_changes"] == 2
        plane.resume()
        _wait_for(lambda: plane.scrub_rounds >= 2
                  and plane.scrub_corrupt >= 1, 10, "walker rounds")
    finally:
        plane.stop()
    assert store.fabric.corruptions_detected == fi.corruptions_injected
    _verify_all(PT, store, name)


# ================================================================== elastic
@pytest.mark.parametrize("n", [4, 7, 12, 20])
def test_storage_resize_plan_matches_the_reference(n):
    def flow(P):
        cm = P.placement.ClusterMap(tuple(f"o{i}" for i in range(n)),
                                    n_pgs=64, replicas=2)
        new, plan = P.elastic.plan_storage_resize(cm, add=("newbie",))
        assert plan.movement_fraction <= 3.0 / (n + 1)
        assert plan.epoch == cm.epoch + 1
        _, shrink = P.elastic.plan_storage_resize(new, remove=("o0",))
        return {"grow": dataclasses.asdict(plan),
                "shrink": dataclasses.asdict(shrink),
                "acting": [new.locate(f"obj.{i}") for i in range(64)]}
    _both(flow)


def test_apply_storage_resize_end_to_end():
    def flow(P):
        store = P.core.make_store(4, replicas=2)
        for i in range(50):
            store.put(f"obj.{i}", bytes([i]) * 100)
        out = P.elastic.apply_storage_resize(store, add=("osd.new.0",))
        assert out["objects_lost"] == 0
        for i in range(50):
            assert store.get(f"obj.{i}") == bytes([i]) * 100
        assert store.osds["osd.new.0"].nbytes() > 0
        shrink = P.elastic.apply_storage_resize(store, remove=("osd.0",))
        assert shrink["objects_lost"] == 0
        return {"grow": out, "shrink": shrink, "fabric": _fab(store),
                "state": _state(store)}
    _both(flow)


@pytest.mark.parametrize("old_dp,new_dp", [(16, 32), (8, 4), (2, 256)])
def test_replan_loader_matches_the_reference(old_dp, new_dp):
    def flow(P):
        out = P.elastic.replan_loader(10_000, 256, old_dp, new_dp)
        assert out["coverage_preserved"]
        with pytest.raises(ValueError):
            P.elastic.replan_loader(10_000, 256, 3, new_dp)
        return out
    _both(flow)


# ================================================================ on the card
@pytest.mark.gpu
def test_skyhook_session_and_compaction_decode_on_the_card():
    """With the default decode, driver scans, session scans and
    compaction merges launch the bitunpack kernel, and agree with the
    plain decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store, vol, omap, table = _append_world(PT, n=1 << 16, unit_rows=512)
    pt_fmt.set_bitunpack_backend("device")
    drv = PT.core.SkyhookDriver(vol, n_workers=4)
    session = PT.core.ScanSession(vol, window_s=0.02)
    try:
        bu.launches = 0
        q = PT.core.Query("ck", filter=("k", "<", 50),
                          aggregate=(("sum", "v"), ("count", "v")))
        r_drv, _ = drv.execute(q)
        assert bu.launches > 0
        bu.launches = 0
        r_sess, _ = session.execute(vol.scan("ck").filter("k", "<", 50)
                                    .agg("sum", "v").agg("count", "v"))
        assert bu.launches > 0
        plane = PT.core.MaintenancePlane(
            store, compact_policy=PT.part.PartitionPolicy(
                target_object_bytes=64 << 10, max_object_bytes=1 << 20))
        bu.launches = 0
        assert plane.compact_step() is not None
        assert bu.launches > 0
        plane.stop()
    finally:
        drv.close()
        pt_fmt.set_bitunpack_backend("plain")
    # the driver folds per-OSD partials in its workers' order, so its
    # float sum may differ from the direct scan's in the last digits
    assert r_drv["count(v)"] == r_sess["count(v)"] == float(
        (table["k"] < 50).sum())
    assert r_drv["sum(v)"] == pytest.approx(r_sess["sum(v)"], rel=1e-12)
    r_plain, _ = vol.scan("ck").filter("k", "<", 50).agg("sum", "v") \
        .agg("count", "v").execute()
    assert r_plain == r_sess
    store.close()
