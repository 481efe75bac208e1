"""pytest plugin: run a suite under the port's dynamic lock checker.

    PYTHONPATH=src python -m pytest -p repro_torch.analysis.pytest_plugin \\
        --lockcheck-torch tests/test_torch_planes.py

``--lockcheck-torch`` installs :mod:`repro_torch.analysis.lockcheck` for
the whole selected suite: every lock of the port's core classes is
instrumented, nested acquisitions build a global order graph, and the
run FAILS if the graph has a cycle (a deadlock hazard, even if nothing
hung) or a ``_GUARDED_BY`` container was mutated without its owning
lock held.  The terminal summary prints the order graph.

The option has its own name so that it never clashes with the JAX
package's ``--lockcheck`` (``tests/conftest.py``) in one run; loading
the plugin without the option changes nothing.
"""

from __future__ import annotations


def pytest_addoption(parser):
    parser.addoption(
        "--lockcheck-torch", action="store_true", default=False,
        help="instrument repro_torch.core locks: fail on lock-order "
             "cycles or guarded-container mutation without the owning "
             "lock")


def pytest_configure(config):
    if config.getoption("--lockcheck-torch"):
        from repro_torch.analysis import lockcheck
        config._lockcheck_torch_state = lockcheck.install()


def pytest_unconfigure(config):
    state = getattr(config, "_lockcheck_torch_state", None)
    if state is not None:
        from repro_torch.analysis import lockcheck
        lockcheck.uninstall(state)
        config._lockcheck_torch_state = None


def pytest_sessionfinish(session, exitstatus):
    state = getattr(session.config, "_lockcheck_torch_state", None)
    if state is not None and not state.report()["ok"] \
            and session.exitstatus == 0:
        session.exitstatus = 1


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    state = getattr(config, "_lockcheck_torch_state", None)
    if state is None:
        return
    rep = state.report()
    tr = terminalreporter
    tr.section("lockcheck (repro_torch)")
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
