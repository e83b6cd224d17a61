"""Shared fixture of the PyTorch port's CPU tests.

The suite runs its test files in several processes at once; torch's default
one-thread-per-core intra-op pool in each of them oversubscribes the CPU
(measured: the port's files took 5x longer in parallel). The port's tests
run torch single-threaded, and put the setting back afterwards.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
