"""The slice as a whole: the same write -> pushdown scan -> OSD loss ->
recover -> re-query flow on ``repro`` and on ``repro_torch``.  Stored
objects, scan results (float64 aggregates included: both run the same
numpy code in the same order) and the fabric's integer counters must
be exactly equal.  Wall-clock fields (``*_s``) are left out."""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as pt_core
from repro.core import format as ref_fmt
from repro.core.store import ObjectStore as RefStore
from repro_torch.core import format as pt_fmt
from repro_torch.core.store import ObjectStore as PtStore
from repro_torch.kernels import bitunpack as bu


@pytest.fixture(autouse=True)
def cpu_decode():
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


def _counters(d: dict) -> dict:
    return {k: v for k, v in d.items() if not k.endswith("_s")}


def _tables():
    rng = np.random.default_rng(0)
    sensors = {"temp": rng.normal(15, 8, 20_000).astype(np.float32),
               "station": rng.integers(0, 50, 20_000).astype(np.int32)}
    rng = np.random.default_rng(1)
    n = 30_000
    events = {"e_pt": rng.gamma(2.0, 20.0, n).astype(np.float32),
              "run": rng.integers(0, 100, n).astype(np.int32),
              "hits": rng.poisson(12, n).astype(np.int32)}
    return sensors, events


def _queries(core, vol):
    """(name, thunk) for each scan of the flow, in order."""
    return [
        ("mean_count", lambda: vol.scan("sensors")
         .filter("station", "==", 7)
         .agg("mean", "temp").agg("count", "temp").execute()),
        ("filter_project", lambda: vol.scan("sensors")
         .filter("temp", "<", -5).project("temp", "station").execute()),
        ("rows_agg", lambda: vol.scan("sensors").rows(1_000, 12_345)
         .filter("temp", ">", 20).agg("mean", "temp").execute()),
        ("or_isin", lambda: vol.scan("sensors")
         .or_(("temp", "<", -10), ("temp", ">", 40))
         .isin("station", [7, 11, 13])
         .project("temp", "station").execute()),
        ("events_sum_count", lambda: vol.scan("events")
         .filter("run", "<", 50)
         .agg("sum", "e_pt").agg("count", "e_pt").execute()),
        ("events_project", lambda: vol.scan("events")
         .filter("hits", ">", 20).project("hits", "run").execute()),
        ("events_rows", lambda: vol.scan("events").rows(4_000, 9_000)
         .project("run", "hits", "e_pt").execute()),
        ("read", lambda: (vol.read(vol.open("events"),
                                   core.RowRange(100, 7_000)), {})),
    ]


def _run_queries(core, vol):
    out = {}
    for name, q in _queries(core, vol):
        before = vol.store.fabric.snapshot()
        result, stats = q()
        after = vol.store.fabric.snapshot()
        delta = {k: after[k] - before[k] for k in _counters(after)}
        out[name] = (result, _counters(stats), delta)
    return out


def _flow(core):
    """Write both tables, scan, lose an OSD, recover, scan again."""
    sensors, events = _tables()
    store = core.make_store(8, replicas=3)
    vol = core.GlobalVOL(store)
    s_ds = core.LogicalDataset(
        "sensors", (core.Column("temp", "float32"),
                    core.Column("station", "int32")),
        n_rows=20_000, unit_rows=512)
    vol.write(vol.create(s_ds, core.PartitionPolicy(
        target_object_bytes=64 << 10)), sensors)
    e_ds = core.LogicalDataset(
        "events", (core.Column("e_pt", "float32"),
                   core.Column("run", "int32"),
                   core.Column("hits", "int32")), 30_000, 4096)
    vol.write(vol.create(e_ds, core.PartitionPolicy(
        target_object_bytes=64 << 10, max_object_bytes=1 << 20)), events)
    written = _counters(store.fabric.snapshot())
    first = _run_queries(core, vol)
    victim = store.cluster.primary(vol.open("events").object_names()[0])
    store.fail_osd(victim)
    recovered = store.recover()
    again = _run_queries(core, vol)
    return store, {"written": written, "first": first,
                   "recovered": recovered, "again": again,
                   "final": _counters(store.fabric.snapshot())}


def _equal(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def _store_contents(store):
    out = {}
    for osd_id, osd in store.osds.items():
        with osd.lock:
            out[osd_id] = (dict(osd.data), {k: dict(v) for k, v in
                                            osd.xattrs.items()})
    return out


def _reference_state(store: RefStore) -> dict:
    """Plain-data state of a reference store, read under its locks."""
    c = store.cluster
    osds = {}
    for osd_id, osd in store.osds.items():
        with osd.lock:
            osds[osd_id] = {"data": dict(osd.data),
                            "xattrs": {k: dict(v)
                                       for k, v in osd.xattrs.items()}}
    with store._lock:
        vclock = store._vclock
    return {"cluster": {"osds": list(c.osds), "n_pgs": c.n_pgs,
                        "replicas": c.replicas, "epoch": c.epoch,
                        "weights": dict(c.weights), "down": sorted(c.down)},
            "osds": osds, "vclock": vclock}


@pytest.fixture(scope="module")
def flows():
    ref_fmt.set_bitunpack_backend("numpy")
    pt_mode = pt_fmt.get_bitunpack_backend()
    pt_fmt.set_bitunpack_backend("plain")
    plain = bu.bitunpack_plain
    decodes = []

    def counted(words, bits, n):
        decodes.append(n)
        return plain(words, bits, n)

    launches = bu.launches
    try:
        ref_store, ref = _flow(ref_core)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bu, "bitunpack_plain", counted)
            pt_store, pt = _flow(pt_core)
    finally:
        ref_fmt.set_bitunpack_backend("auto")
        pt_fmt.set_bitunpack_backend(pt_mode)
    pt["decodes"] = decodes
    pt["launches"] = bu.launches - launches
    yield ref_store, ref, pt_store, pt
    ref_store.close()
    pt_store.close()


def test_stored_objects_identical(flows):
    ref_store, _, pt_store, _ = flows
    ref_c, pt_c = _store_contents(ref_store), _store_contents(pt_store)
    assert sorted(ref_c) == sorted(pt_c)
    n_objects = 0
    for osd_id in ref_c:
        assert pt_c[osd_id][0] == ref_c[osd_id][0], osd_id
        assert pt_c[osd_id][1] == ref_c[osd_id][1], osd_id
        n_objects += len(ref_c[osd_id][0])
    assert n_objects > 3 * 8  # replicated, on every OSD


@pytest.mark.parametrize("phase", ["written", "first", "recovered", "again",
                                   "final"])
def test_flow_results_and_counters_identical(flows, phase):
    _, ref, _, pt = flows
    _equal(ref[phase], pt[phase], phase)


def test_flow_results_match_numpy(flows):
    _, _, _, pt = flows
    sensors, events = _tables()
    for phase in ("first", "again"):
        res = pt[phase]
        m = sensors["station"] == 7
        got = res["mean_count"][0]
        assert got["count(temp)"] == m.sum()
        assert got["mean(temp)"] == pytest.approx(
            sensors["temp"][m].astype(np.float64).mean(), rel=1e-9)
        m = events["run"] < 50
        got = res["events_sum_count"][0]
        assert got["count(e_pt)"] == m.sum()
        assert got["sum(e_pt)"] == pytest.approx(
            events["e_pt"][m].astype(np.float64).sum(), rel=1e-9)
        m = events["hits"] > 20
        got = res["events_project"][0]
        assert np.array_equal(got["hits"], events["hits"][m])
        assert np.array_equal(got["run"], events["run"][m])
        got = res["events_rows"][0]
        for k in ("run", "hits", "e_pt"):
            assert np.array_equal(got[k], events[k][4_000:9_000])
        got = res["read"][0]
        for k in ("run", "hits", "e_pt"):
            assert np.array_equal(got[k], events[k][100:7_000])
    # the ops were pushed down: a filter->agg costs at most one request
    # per up OSD
    assert pt["first"]["events_sum_count"][2]["ops"] <= 8
    assert pt["recovered"]["objects_lost"] == 0


def test_bitpack_columns_decoded_by_the_plain_version(flows):
    ref_store, _, _, pt = flows
    codecs = set()
    for osd in ref_store.osds.values():
        with osd.lock:
            blobs = [b for n, b in osd.data.items() if b[:4] == b"SKYB"]
        for b in blobs:
            codecs |= {c["codec"] for c in ref_fmt.block_header(b)["columns"]}
    assert {"bitpack6", "bitpack7"} <= codecs
    assert len(pt["decodes"]) > 0 and pt["launches"] == 0


def test_from_state_round_trip(flows):
    ref_store, ref, _, _ = flows
    loaded = PtStore.from_state(_reference_state(ref_store))
    try:
        assert _store_contents(loaded) == _store_contents(ref_store)
        exported = loaded.export_state()
        again = PtStore.from_state(exported)
        assert _store_contents(again) == _store_contents(ref_store)
        assert again.export_state() == exported
        again.close()
        vol = pt_core.GlobalVOL(loaded)
        for name, q in _queries(pt_core, vol):
            _equal(ref["again"][name][0], q()[0], name)
        # a write on the loaded store continues the reference's clock
        assert loaded.put("extra", b"x") == ref_store._vclock + 1
    finally:
        loaded.close()


@pytest.mark.gpu
def test_flow_on_card_matches_reference(flows):
    """The same flow with every bitpack column decoded by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, ref, _, _ = flows
    pt_fmt.set_bitunpack_backend("device")
    launches = bu.launches
    store, got = _flow(pt_core)
    store.close()
    assert bu.launches > launches
    for phase in ("written", "first", "recovered", "again", "final"):
        _equal(ref[phase], got[phase], phase)
