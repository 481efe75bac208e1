"""A cap on torch's intra-op threads for the port's heavy single-process
test files (``test_torch_models``, ``_train``, ``_ssm``, ``_moe``).

Their products are small (smoke widths), so more threads buy them
little, while each ran at 150-320% CPU under the suite's 6 xdist workers
beside the reference's timing-sensitive tests (``test_streaming_plane``'s
ledger peaks, ``test_torch_planes``'s daemons).  A file imports
``few_torch_threads`` (module-scoped, autouse): torch runs on
``TORCH_THREADS`` threads while the file's tests run, and on its former
count afterwards."""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)
