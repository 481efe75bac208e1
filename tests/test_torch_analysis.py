"""The port's verification plane (``repro_torch.analysis``) held to the
reference's (``repro.analysis``).

Each test of ``tests/test_analysis.py`` has its counterpart here: every
AST pass fires on the reference test's seeded violations and stays
quiet on its clean module, written under ``src/repro_torch/core`` in
``tmp_path``; the registry pass with injected tables; the suppression
machinery; the lockcheck unit cases.  Beside those: the port's passes
give the reference's findings on the same sources (the reference test's
fixtures and the port's own tree), the port's registry holds the
reference's ops with the same digests, ``python -m repro_torch.analysis``
is clean on the repo, the harness over a live port store (scans, a
threaded ``ScanSession``, a maintenance pass) records no cycle and no
violation, and ``--lockcheck-torch`` fails a pytest run whose test
nests two port locks in opposite orders.
"""

import copy
import os
import pickle
import shutil
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
from test_analysis import CLEAN, VIOLATIONS

from repro_torch.analysis import invariants, lockcheck, registry
from repro_torch.analysis.base import (Finding, SuppressionError,
                                       apply_suppressions, load_suppressions)
from repro_torch.analysis.cli import main as analysis_main
from repro_torch.core import format as pt_fmt

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_decode():
    mode = pt_fmt.get_bitunpack_backend()
    pt_fmt.set_bitunpack_backend("plain")
    yield
    pt_fmt.set_bitunpack_backend(mode)


# --------------------------------------------------------------------------
# fixture trees
# --------------------------------------------------------------------------


def _tree(tmp_path, source: str, name: str = "storeish.py",
          pkg: str = "repro_torch"):
    core = tmp_path / "src" / pkg / "core"
    core.mkdir(parents=True, exist_ok=True)
    (core / name).write_text(textwrap.dedent(source))
    return tmp_path


def _rules(findings, rule):
    return [f for f in findings if f.rule == rule]


# --------------------------------------------------------------------------
# AST passes fire on seeded violations
# --------------------------------------------------------------------------


class TestSeededViolations:
    @pytest.fixture(scope="class")
    def findings(self, tmp_path_factory):
        root = _tree(tmp_path_factory.mktemp("bad"), VIOLATIONS)
        return invariants.analyze(root)

    def test_accounting_submit_root_fires(self, findings):
        hits = _rules(findings, "accounting")
        assert any("kickoff.worker" in f.qualname
                   and "Fabric.ops" in f.message for f in hits)

    def test_accounting_thread_root_fires(self, findings):
        hits = _rules(findings, "accounting")
        assert any(f.qualname == "ObjectStore._loop"
                   and "Fabric.ops" in f.message for f in hits)

    def test_accounting_daemon_counter_exempt(self, findings):
        assert not any("scrub_bytes" in f.message
                       for f in _rules(findings, "accounting"))

    def test_lock_guard_fires(self, findings):
        hits = _rules(findings, "lock-guard")
        assert [f.qualname for f in hits] == ["OSD.read_bad"]

    def test_lock_blocking_fires(self, findings):
        hits = _rules(findings, "lock-blocking")
        assert [f.qualname for f in hits] == ["OSD.sleepy"]
        assert "time.sleep" in hits[0].message

    def test_write_path_d1_fires(self, findings):
        hits = _rules(findings, "write-path")
        assert any(f.qualname == "OSD.rot"
                   and "invalidation" in f.message for f in hits)

    def test_write_path_d2_fires(self, findings):
        hits = _rules(findings, "write-path")
        assert any(f.qualname == "ObjectStore.half_write"
                   and "content_digest" in f.message for f in hits)

    def test_findings_name_the_ports_tree(self, findings):
        assert findings and all(
            f.file == "src/repro_torch/core/storeish.py" for f in findings)

    def test_clean_module_is_quiet(self, tmp_path):
        root = _tree(tmp_path, CLEAN)
        assert invariants.analyze(root) == []

    def test_reference_tree_is_not_read(self, tmp_path):
        """The port's linter reads ``src/repro_torch`` only: violations
        under ``src/repro`` are the reference linter's business."""
        root = _tree(tmp_path, VIOLATIONS, pkg="repro")
        (tmp_path / "src" / "repro_torch" / "core").mkdir(parents=True)
        assert invariants.analyze(root) == []


# --------------------------------------------------------------------------
# parity with the reference's passes on the same sources
# --------------------------------------------------------------------------


def _normalized(findings, pkg: str):
    prefix = f"src/{pkg}/"
    return sorted((f.rule, f.file.replace(prefix, "src/"), f.line,
                   f.qualname, f.message.replace(prefix, "src/"))
                  for f in findings)


def _port_sources(dst: Path) -> None:
    """The port's own ``core`` and ``serve`` sources, copied to ``dst``'s
    ``core`` and ``serve`` folders."""
    for sub in ("core", "serve"):
        (dst / sub).mkdir(parents=True, exist_ok=True)
        for p in (ROOT / "src" / "repro_torch" / sub).glob("*.py"):
            shutil.copy(p, dst / sub / p.name)


@pytest.mark.parametrize("sources", ["violations", "clean", "port tree"])
def test_passes_match_the_reference(tmp_path, sources):
    from repro.analysis import invariants as ref_invariants

    roots = {}
    for pkg in ("repro", "repro_torch"):
        root = tmp_path / pkg
        if sources == "port tree":
            _port_sources(root / "src" / pkg)
        else:
            _tree(root, VIOLATIONS if sources == "violations" else CLEAN,
                  pkg=pkg)
        roots[pkg] = root
    want = _normalized(ref_invariants.analyze(roots["repro"]), "repro")
    got = _normalized(invariants.analyze(roots["repro_torch"]),
                      "repro_torch")
    assert got == want
    if sources != "clean":
        assert {f[0] for f in got} == {"accounting", "lock-guard",
                                       "lock-blocking", "write-path"}


# --------------------------------------------------------------------------
# registry pass (injected tables and the real registry)
# --------------------------------------------------------------------------


class TestRegistryPass:
    def test_missing_rep_params(self):
        hits = registry.check_registry(reps={}, ops=("select",))
        assert any("representative params" in f.message for f in hits)

    def test_undeclared_not_mergeable(self):
        hits = registry.check_registry(
            ops=("median",), not_mergeable=frozenset())
        assert any("KNOWN_NOT_MERGEABLE" in f.message
                   and f.qualname == "op:median" for f in hits)

    def test_stale_not_mergeable_declaration(self):
        hits = registry.check_registry(
            ops=("agg",),
            not_mergeable=frozenset({"agg"}))
        assert any("stale" in f.message and f.qualname == "op:agg"
                   for f in hits)

    def test_undeclared_col_conservative(self):
        hits = registry.check_registry(
            ops=("recompress",), col_conservative=frozenset())
        assert any("KNOWN_COL_CONSERVATIVE" in f.message
                   for f in hits)

    def test_stale_col_conservative_declaration(self):
        hits = registry.check_registry(
            ops=("agg",), col_conservative=frozenset({"agg"}))
        assert any("stale" in f.message and f.qualname == "op:agg"
                   for f in hits)

    def test_real_registry_is_fully_declared(self):
        assert registry.check_registry() == []

    def test_findings_name_the_ports_file(self):
        hits = registry.check_registry(reps={}, ops=("select",))
        assert [f.file for f in hits] == ["src/repro_torch/core/objclass.py"]

    def test_same_ops_and_tables_as_the_reference(self):
        from repro.analysis import registry as ref_registry
        from repro.core import objclass as ref_oc

        from repro_torch.core import objclass as pt_oc
        assert pt_oc.registered_ops() == ref_oc.registered_ops()
        assert registry.KNOWN_NOT_MERGEABLE == \
            ref_registry.KNOWN_NOT_MERGEABLE
        assert registry.KNOWN_COL_CONSERVATIVE == \
            ref_registry.KNOWN_COL_CONSERVATIVE
        assert registry.REP_PARAMS == ref_registry.REP_PARAMS

    @pytest.mark.parametrize("name", sorted(registry.REP_PARAMS))
    def test_wire_digest_equals_the_reference(self, name):
        """The byte formats are shared: an op's params digest the same
        in both packages, before and after the wire round trip."""
        import json

        from repro.core import objclass as ref_oc

        from repro_torch.core import objclass as pt_oc
        rep = registry.REP_PARAMS[name]
        o = pt_oc.ObjOp(name, rep)
        back = pt_oc.ObjOp.from_json(json.loads(json.dumps(o.to_json())))
        want = ref_oc.pipeline_digest([ref_oc.ObjOp(name, rep)])
        assert pt_oc.pipeline_digest([o]) == want
        assert pt_oc.pipeline_digest([back]) == want


# --------------------------------------------------------------------------
# suppression machinery
# --------------------------------------------------------------------------


class TestSuppressions:
    def test_justification_required(self, tmp_path):
        p = tmp_path / "s.txt"
        p.write_text("lock-guard cache.py:ResultCache._evict_lru\n")
        with pytest.raises(SuppressionError):
            load_suppressions(p)

    def test_match_and_stale(self, tmp_path):
        p = tmp_path / "s.txt"
        p.write_text(
            "lock-guard x.py:A.f -- caller holds the lock\n"
            "accounting y.py:B.g -- never matches\n")
        supps = load_suppressions(p)
        f = Finding("lock-guard", "src/x.py", 3, "A.f", "m")
        active, quiet, unused = apply_suppressions([f], supps)
        assert active == [] and quiet == [f]
        assert [s.key for s in unused] == ["accounting y.py:B.g"]

    def test_ports_file_keeps_the_references_keys(self):
        from repro.analysis.cli import DEFAULT_SUPPRESSIONS as ref_file

        from repro_torch.analysis.cli import DEFAULT_SUPPRESSIONS
        ref = {s.key for s in load_suppressions(ref_file)}
        port = {s.key for s in load_suppressions(DEFAULT_SUPPRESSIONS)}
        assert len(ref) == 10 and ref <= port
        assert port - ref == {"write-path store.py:ObjectStore.from_state"}

    def test_stale_key_fails_the_run(self, tmp_path, capsys):
        from repro_torch.analysis.cli import DEFAULT_SUPPRESSIONS
        p = tmp_path / "s.txt"
        p.write_text(DEFAULT_SUPPRESSIONS.read_text()
                     + "accounting store.py:Nowhere.f -- matches nothing\n")
        assert analysis_main(["--suppressions", str(p)]) == 1
        assert "stale suppression" in capsys.readouterr().out

    def test_unsuppressed_finding_fails_the_run(self, tmp_path, capsys):
        p = tmp_path / "s.txt"
        p.write_text("")
        assert analysis_main(["--suppressions", str(p)]) == 1
        assert "ObjectStore.from_state" in capsys.readouterr().out


# --------------------------------------------------------------------------
# dynamic lockcheck harness
# --------------------------------------------------------------------------


class TestLockCheck:
    def test_cycle_detected(self):
        st = lockcheck.LockCheckState()
        a = lockcheck.InstrumentedLock("A", st)
        b = lockcheck.InstrumentedLock("B", st)
        with a:
            with b:
                pass
        with b:
            with a:                 # inverted order: A<->B cycle
                pass
        assert st.cycles() == [["A", "B"]]
        assert not st.report()["ok"]

    def test_same_name_self_edge_is_cycle(self):
        st = lockcheck.LockCheckState()
        a1 = lockcheck.InstrumentedLock("OSD.lock", st)
        a2 = lockcheck.InstrumentedLock("OSD.lock", st)
        with a1:
            with a2:                # two instances of the same lock
                pass
        assert st.cycles() == [["OSD.lock"]]

    def test_consistent_order_is_clean(self):
        st = lockcheck.LockCheckState()
        a = lockcheck.InstrumentedLock("A", st)
        b = lockcheck.InstrumentedLock("B", st)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert st.cycles() == []
        assert st.report()["ok"]

    def test_guarded_mutation_without_lock_flagged(self):
        st = lockcheck.LockCheckState()
        owner = lockcheck.InstrumentedLock("C._lock", st)
        d = lockcheck._wrap_container({}, "C.table", owner, st)
        d["k"] = 1                  # mutation, lock not held
        assert any("C.table" in v for v in st.report()["violations"])

    def test_guarded_mutation_under_lock_clean(self):
        st = lockcheck.LockCheckState()
        owner = lockcheck.InstrumentedLock("C._lock", st)
        d = lockcheck._wrap_container({}, "C.table", owner, st)
        with owner:
            d["k"] = 1
            d.pop("k")
        assert st.report()["violations"] == []
        assert d == {}

    def test_cross_thread_order_edges_merge(self):
        st = lockcheck.LockCheckState()
        a = lockcheck.InstrumentedLock("A", st)
        b = lockcheck.InstrumentedLock("B", st)

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        th1 = threading.Thread(target=t1)
        th1.start()
        th1.join()
        th2 = threading.Thread(target=t2)
        th2.start()
        th2.join()
        assert st.cycles() == [["A", "B"]]

    @pytest.mark.parametrize("kind", [dict, set, "ordered"])
    def test_copy_of_guarded_container_is_plain(self, kind):
        """A snapshot of a guarded container (copy, deepcopy, pickle) is
        its base type, equal, and carries no lock."""
        from collections import OrderedDict
        base = OrderedDict if kind == "ordered" else kind
        value = base([("a", [1]), ("b", [2])]) if base is not set \
            else {"a", "b"}
        st = lockcheck.LockCheckState()
        owner = lockcheck.InstrumentedLock("C._lock", st)
        d = lockcheck._wrap_container(value, "C.table", owner, st)
        assert type(d) is not base
        for snap in (copy.copy(d), copy.deepcopy(d),
                     pickle.loads(pickle.dumps(d))):
            assert type(snap) is base and snap == value
        assert st.report()["violations"] == []

    def test_install_over_real_store(self):
        st = lockcheck.install()
        try:
            from repro_torch.core.store import make_store
            store = make_store(3, replicas=2, cache_bytes=1 << 20)
            store.put("obj/0", b"x" * 512)
            assert store.get("obj/0") == b"x" * 512
            store.delete("obj/0")
            store.close()
        finally:
            lockcheck.uninstall(st)
        rep = st.report()
        assert rep["locks_instrumented"] > 0
        assert rep["containers_instrumented"] > 0
        assert rep["acquisitions"] > 0
        assert rep["ok"], rep

    def test_uninstall_restores_the_classes(self):
        from repro_torch.core import store as pt_store
        init = pt_store.OSD.__init__
        st = lockcheck.install()
        assert pt_store.OSD.__init__ is not init
        lockcheck.uninstall(st)
        assert pt_store.OSD.__init__ is init
        store = pt_store.make_store(2, replicas=1)
        assert not isinstance(store._lock, lockcheck.InstrumentedLock)
        store.close()

    def test_install_over_live_store_planes(self):
        """Scans, one ``ScanSession`` shared by 8 threads, a
        ``MaintenancePlane`` pass and a state round trip, all under the
        harness: no cycle, no ownership violation."""
        st = lockcheck.install()
        try:
            from repro_torch.core import (Column, GlobalVOL, LogicalDataset,
                                          MaintenancePlane, PartitionPolicy,
                                          ScanSession, make_store)
            from repro_torch.core.store import ObjectStore
            store = make_store(4, replicas=2, cache_bytes=4 << 20)
            try:
                vol = GlobalVOL(store)
                rng = np.random.default_rng(0)
                n = 8192
                table = {"v": rng.normal(size=n),
                         "k": rng.integers(0, 100, n).astype(np.int32)}
                ds = LogicalDataset("t", (Column("v", "float64"),
                                          Column("k", "int32")),
                                    n_rows=n, unit_rows=256)
                vol.write(vol.create(ds, PartitionPolicy(
                    target_object_bytes=8 << 10)), table)
                q = vol.scan("t").filter("k", "<", 50).agg("sum", "v")
                want = float(table["v"][table["k"] < 50].sum())
                assert q.execute()[0] == pytest.approx(want, rel=1e-9)
                rows, _ = (vol.scan("t").filter("k", "==", 7)
                           .project("v").execute())
                assert len(rows["v"]) == int((table["k"] == 7).sum())

                sess = ScanSession(vol, window_s=0.01)
                got, errors = [], []

                def client():
                    try:
                        got.append(sess.execute(q)[0])
                    except Exception as e:      # noqa: BLE001 - reported
                        errors.append(e)
                threads = [threading.Thread(target=client)
                           for _ in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not errors and len(got) == 8
                assert all(g == pytest.approx(want, rel=1e-9) for g in got)

                plane = MaintenancePlane(store, compact_policy=PartitionPolicy(
                    target_object_bytes=64 << 10), compact_datasets=["t"])
                plane.run_once()
                assert q.execute()[0] == pytest.approx(want, rel=1e-9)
                again = ObjectStore.from_state(store.export_state())
                again.close()
            finally:
                store.close()
        finally:
            lockcheck.uninstall(st)
        rep = st.report()
        assert rep["locks_instrumented"] > 0
        assert rep["containers_instrumented"] > 0
        assert rep["acquisitions"] > 100
        assert rep["ok"], rep


SEEDED_CYCLE = """\
    from repro_torch.core.store import make_store


    def test_opposite_orders():
        store = make_store(2, replicas=1)
        osd = next(iter(store.osds.values()))
        with store._lock:
            with osd.lock:
                pass
        with osd.lock:
            with store._lock:
                pass
        store.close()
"""


@pytest.mark.parametrize("flag", [True, False])
def test_pytest_plugin_fails_a_seeded_cycle(tmp_path, flag):
    """``--lockcheck-torch`` turns a run whose one test passes into a
    failed run when the test nests two port locks in opposite orders;
    without the option the plugin changes nothing."""
    (tmp_path / "test_seeded.py").write_text(textwrap.dedent(SEEDED_CYCLE))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "no:xdist", "-p", "no:randomly",
           "-p", "repro_torch.analysis.pytest_plugin", "test_seeded.py"]
    out = subprocess.run(cmd + (["--lockcheck-torch"] if flag else []),
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    text = out.stdout + out.stderr
    assert "1 passed" in text, text
    if flag:
        assert out.returncode != 0, text
        assert ("LOCK-ORDER CYCLE: OSD.lock -> ObjectStore._lock"
                in text), text
    else:
        assert out.returncode == 0, text
        assert "lockcheck" not in text


# --------------------------------------------------------------------------
# the repo itself is clean
# --------------------------------------------------------------------------


def test_repo_baseline_clean(capsys):
    assert analysis_main([]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out
    assert "0 stale" in out


def test_module_entry_point_exits_zero():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.analysis: 0 finding(s), 49 suppressed, 0 stale" \
        in out.stdout
