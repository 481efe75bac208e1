"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device; only launch/dryrun.py fakes a 512-chip pod.

``--lockcheck`` runs the whole selected suite under the dynamic
lock-order / lock-ownership harness (``repro.analysis.lockcheck``):
every core lock is instrumented, nested acquisitions build a global
order graph, and the run FAILS if the graph has a cycle (deadlock
hazard, even if nothing hung) or a ``_GUARDED_BY`` container was
mutated without its owning lock held.
"""

import numpy as np
import pytest


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--lockcheck", action="store_true", default=False,
        help="instrument repro.core locks: fail on lock-order cycles "
             "or guarded-container mutation without the owning lock")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); each "
                   "such test decides inside itself and skips without one")
    if config.getoption("--lockcheck"):
        from repro.analysis import lockcheck
        config._lockcheck_state = lockcheck.install()


def pytest_unconfigure(config):
    state = getattr(config, "_lockcheck_state", None)
    if state is not None:
        from repro.analysis import lockcheck
        lockcheck.uninstall(state)
        config._lockcheck_state = None


def pytest_sessionfinish(session, exitstatus):
    state = getattr(session.config, "_lockcheck_state", None)
    if state is not None and not state.report()["ok"] \
            and session.exitstatus == 0:
        session.exitstatus = 1


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    state = getattr(config, "_lockcheck_state", None)
    if state is None:
        return
    rep = state.report()
    tr = terminalreporter
    tr.section("lockcheck")
    tr.line(f"acquisitions: {rep['acquisitions']}  "
            f"locks instrumented: {rep['locks_instrumented']}  "
            f"guarded containers: {rep['containers_instrumented']}")
    for a, bs in rep["order_edges"].items():
        tr.line(f"order: {a} -> {', '.join(bs)}")
    for cyc in rep["cycles"]:
        tr.line(f"LOCK-ORDER CYCLE: {' -> '.join(cyc)}", red=True)
    for v in rep["violations"]:
        tr.line(f"OWNERSHIP VIOLATION: {v}", red=True)
    if rep["ok"]:
        tr.line("lockcheck: no cycles, no ownership violations")
