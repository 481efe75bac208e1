"""Verification plane of the port: static invariant linter + dynamic
lock checker, aimed at ``src/repro_torch``.

``python -m repro_torch.analysis`` runs the AST passes (accounting, lock
discipline, blocking-while-locked, write-path completeness) over the
port's ``core/`` and ``serve/`` and the registry completeness pass over
its objclass registry; ``repro_torch.analysis.lockcheck`` is the runtime
half — an instrumented-lock harness the test suite can switch on with
``pytest -p repro_torch.analysis.pytest_plugin --lockcheck-torch``.  See
this package's README.md for the contract list.
"""

from repro_torch.analysis.base import Finding  # noqa: F401
