"""pytest settings of the benchmark's own tests (``perfbench/tests``):
the repository root on the path, so ``import perfbench`` works, and the
``gpu`` marker of tests that need a CUDA card; each such test decides
inside itself whether there is one, and skips without it."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; each such test decides "
                   "inside itself and skips without one")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while a module of these tests runs: the suite
    runs in several worker processes at once, and the smoke models' many
    small operations slow down tenfold when every worker spreads each
    over every core."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def bitunpack_backend_restored():
    """The harness selects the program's process-wide bitunpack backend
    (the plain decode on the CPU); each module of these tests leaves it as
    it found it, for the program's own tests that run after it in the same
    worker process."""
    from repro_torch.core import format as fmt

    before = fmt.get_bitunpack_backend()
    yield
    fmt.set_bitunpack_backend(before)
