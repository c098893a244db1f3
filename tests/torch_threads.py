"""A module-scoped fixture for the port's CPU tests: one torch intra-op
thread while a test file runs.

Their tensors are tiny, so threads buy nothing, and tier-1 runs 6 test
files at once in separate processes: with torch's default of one thread a
core in each process, the processes oversubscribe the cores and small
operations slow down by an order of magnitude. Import the fixture by name
into a test module to use it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
