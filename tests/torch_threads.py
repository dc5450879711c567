"""One PyTorch intra-op thread for a test module of the port.

The port's CPU tests run its plain versions on small tensors. Under the
parallel test runner every worker's PyTorch would start one intra-op
thread per core, and several workers together oversubscribe the cores
many times over: the threads' hand-offs, not the arithmetic, then take
most of each test's time. A module that imports `one_torch_thread` runs
its tests, fixtures included, with one intra-op thread and restores the
previous count after its last test.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
