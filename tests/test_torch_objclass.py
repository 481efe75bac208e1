"""The port's objclass (storage-side op pipeline) against the reference's:
equal pipeline digests (they key the OSD caches), equal results of the
same pipelines on the same blobs, equal late row-range and hyperslab
resolution, packed select and compaction."""

import numpy as np
import pytest

from repro.core import expr as ref_ex
from repro.core import format as ref_fmt
from repro.core import objclass as ref_oc
from repro_torch.core import expr as pt_ex
from repro_torch.core import format as pt_fmt
from repro_torch.core import objclass as pt_oc


@pytest.fixture(autouse=True)
def cpu_decode():
    pt_mode = pt_fmt.get_bitunpack_backend()
    ref_fmt.set_bitunpack_backend("numpy")
    pt_fmt.set_bitunpack_backend("plain")
    yield
    ref_fmt.set_bitunpack_backend("auto")
    pt_fmt.set_bitunpack_backend(pt_mode)


SPACE = {"name": "grid", "shape": [10, 12], "dtype": "float32",
         "chunk": [4, 4]}
SEL = {"starts": [1, 2], "stops": [9, 11], "steps": [2, 3], "squeeze": []}


def _pipelines(oc, ex):
    """The same pipelines, built from one package's own classes."""
    tree = ex.Or((ex.And((ex.Cmp("run", "<", 50),
                          ex.Between("e_pt", 5.0, 80.0))),
                  ex.In("hits", (3, 7, 11)),
                  ex.Not(ex.Cmp("run", ">=", 2))))
    return {
        "filter_agg": [oc.op("filter", col="run", cmp="<", value=50),
                       oc.op("agg", col="e_pt", fn="mean")],
        "tree_filter_count": [oc.op("filter", expr=tree),
                              oc.op("agg", col="e_pt", fn="count")],
        "tree_wire_filter_sum": [oc.op("filter", expr=tree.to_json()),
                                 oc.op("agg", col="hits", fn="sum")],
        "multi_agg": [oc.op("filter", col="hits", cmp=">", value=10),
                      oc.op("multi_agg", specs=[("sum", "e_pt"),
                                                ("min", "run"),
                                                ("max", "hits"),
                                                ("mean", "e_pt"),
                                                ("count", "run")])],
        "filter_project": [oc.op("filter", col="hits", cmp=">", value=20),
                           oc.op("project", cols=["e_pt", "hits"])],
        "select_project": [oc.op("select", rows=(17, 300)),
                           oc.op("project", cols=["run"])],
        "empty_agg": [oc.op("filter", col="run", cmp=">", value=1000),
                      oc.op("agg", col="e_pt", fn="min")],
        "sketch": [oc.op("quantile_sketch", col="e_pt", lo=0.0, hi=200.0,
                         bins=64)],
        "median": [oc.op("median", col="hits")],
    }


def _digest_only(oc):
    return {
        "row_slice": [oc.op("row_slice", rows=(100, 2000)),
                      oc.op("agg", col="e_pt", fn="sum")],
        "hyperslab": [oc.op("hyperslab_slice", space=SPACE, sel=SEL)],
        "np_params": [oc.op("filter", col="run", cmp="==",
                            value=np.int32(7)),
                      oc.op("select", rows=(np.int64(1), np.int64(5)))],
    }


def _events(n, seed):
    rng = np.random.default_rng(seed)
    return {"e_pt": rng.gamma(2.0, 20.0, n).astype(np.float32),
            "run": rng.integers(0, 100, n).astype(np.int32),
            "hits": rng.poisson(12, n).astype(np.int32)}


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (bytes, bytearray)):
        assert a == b
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_pipeline_digest_equal():
    ref_p = {**_pipelines(ref_oc, ref_ex), **_digest_only(ref_oc)}
    pt_p = {**_pipelines(pt_oc, pt_ex), **_digest_only(pt_oc)}
    assert list(ref_p) == list(pt_p)
    digests = set()
    for name in ref_p:
        d = pt_oc.pipeline_digest(pt_p[name])
        assert d == ref_oc.pipeline_digest(ref_p[name]), name
        digests.add(d)
        # the normalized (parsed-Expr) form digests like its wire form
        assert pt_oc.pipeline_digest(pt_oc.normalize_exprs(pt_p[name])) == d
    assert len(digests) == len(ref_p)


@pytest.mark.parametrize("codecs", ["auto", "none"])
def test_run_pipeline_results_equal(codecs):
    table = _events(2000, 3)
    blob = ref_fmt.encode_block(
        table, codecs=ref_fmt.auto_codecs(table) if codecs == "auto" else {})
    ref_p, pt_p = _pipelines(ref_oc, ref_ex), _pipelines(pt_oc, pt_ex)
    for name in ref_p:
        assert (pt_oc.required_columns(pt_p[name])
                == ref_oc.required_columns(ref_p[name])), name
        want = ref_oc.run_pipeline(blob, ref_p[name])
        got = pt_oc.run_pipeline(blob, pt_p[name])
        _equal(want, got)
        assert (pt_oc.pipeline_mergeable(pt_p[name])
                == ref_oc.pipeline_mergeable(ref_p[name]))
        if pt_oc.pipeline_mergeable(pt_p[name]):
            parts = [pt_oc.run_pipeline(blob, pt_p[name]) for _ in range(3)]
            ref_parts = [ref_oc.run_pipeline(blob, ref_p[name])
                         for _ in range(3)]
            _equal(ref_oc.merge_partials(ref_p[name], ref_parts),
                   pt_oc.merge_partials(pt_p[name], parts))
            _equal(ref_oc.combine_partials(ref_p[name], ref_parts),
                   pt_oc.combine_partials(pt_p[name], parts))


def test_filter_agg_over_bitpack9_column():
    """The reference's device-decode case: filter -> agg over bitpack9."""
    rng = np.random.default_rng(11)
    table = {"a": rng.integers(0, 1 << 9, 500).astype(np.int32),
             "b": rng.normal(size=500)}
    blob = ref_fmt.encode_block(table, codecs={"a": "bitpack9"})
    want = ref_oc.run_pipeline(blob, [
        ref_oc.op("filter", col="a", cmp=">=", value=100),
        ref_oc.op("agg", col="b", fn="sum")])
    got = pt_oc.run_pipeline(blob, [
        pt_oc.op("filter", col="a", cmp=">=", value=100),
        pt_oc.op("agg", col="b", fn="sum")])
    assert float(got["sum"]) == float(want["sum"])
    assert np.array_equal(pt_fmt.decode_block(blob)["a"], table["a"])


@pytest.mark.parametrize("extent", [(0, 500), (400, 900), (3000, 4000)])
@pytest.mark.parametrize("clamp", [False, True])
def test_resolve_row_slice_equal(extent, clamp):
    ref_ops = [ref_oc.op("row_slice", rows=(450, 2500)),
               ref_oc.op("project", cols=["run"])]
    pt_ops = [pt_oc.op("row_slice", rows=(450, 2500)),
              pt_oc.op("project", cols=["run"])]
    want = ref_oc.resolve_row_slice(ref_ops, extent, clamp=clamp)
    got = pt_oc.resolve_row_slice(pt_ops, extent, clamp=clamp)
    assert (want is None) == (got is None)
    if want is not None:
        assert [o.to_json() for o in got] == [o.to_json() for o in want]


@pytest.mark.parametrize("chunks", [(0, 3), (3, 9), (9, 12)])
def test_resolve_hyperslab_equal(chunks):
    n = chunks[1] - chunks[0]
    rng = np.random.default_rng(chunks[0])
    data = rng.normal(size=(n, 4, 4)).astype(np.float32)
    zms = [{"data": [float(c.min()), float(c.max())]} for c in data]
    blob = ref_fmt.encode_block({"data": data})
    for where in (None, ("data", ">", 1.5)):
        rw = ref_ex.Cmp(*where) if where else None
        pw = pt_ex.Cmp(*where) if where else None
        want, wn = ref_oc.resolve_hyperslab(
            [ref_oc.op("hyperslab_slice", space=SPACE, sel=SEL)], chunks,
            chunk_zone_maps=zms, where=rw)
        got, gn = pt_oc.resolve_hyperslab(
            [pt_oc.op("hyperslab_slice", space=SPACE, sel=SEL)], chunks,
            chunk_zone_maps=zms, where=pw)
        assert wn == gn and (want is None) == (got is None)
        if want is not None:
            assert [o.to_json() for o in got] == [o.to_json() for o in want]
            _equal(ref_oc.run_pipeline(blob, want),
                   pt_oc.run_pipeline(blob, got))


def test_select_packed_equal():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 1 << 11, (40, 128)).astype(np.int32)
    blob = ref_fmt.encode_block({"tokens": toks},
                                codecs={"tokens": "bitpack11"})
    want = ref_oc.run_pipeline(blob, [ref_oc.op(
        "select_packed", rows=(3, 17), col="tokens")])
    got = pt_oc.run_pipeline(blob, [pt_oc.op(
        "select_packed", rows=(3, 17), col="tokens")])
    _equal(want, got)


def test_compact_merge_and_concat_equal():
    blobs = [ref_fmt.encode_block(_events(n, n)) for n in (10, 300, 77)]
    want_blob, want_zm = ref_oc.compact_merge(blobs)
    got_blob, got_zm = pt_oc.compact_merge(blobs)
    assert got_blob == want_blob and got_zm == want_zm
    tables = [_events(n, n + 1) for n in (5, 50)]
    assert pt_oc.concat_encode(tables) == ref_oc.concat_encode(tables)


def test_zone_map_prunes_equal():
    zm = {"run": [0.0, 40.0], "e_pt": [1.0, 9.0]}
    for leaf in [("run", ">", 50), ("run", "<", 50), ("e_pt", "==", 12.0),
                 ("e_pt", "!=", 3.0), ("run", ">=", 40)]:
        assert (pt_oc.zone_map_prunes(zm, pt_ex.Cmp(*leaf))
                == ref_oc.zone_map_prunes(zm, ref_ex.Cmp(*leaf)))
    # other test files register extra ops in the reference's process-wide
    # registry, so the built-in set is compared, not equality
    builtins = {"select", "project", "filter", "agg", "multi_agg", "median",
                "quantile_sketch", "recompress", "select_packed",
                "row_slice", "hyperslab_slice", "hyperslab_local",
                "compact_merge"}
    assert set(pt_oc.registered_ops()) == builtins
    assert builtins <= set(ref_oc.registered_ops())
