"""The ``one_thread`` fixture of the port's CPU tests.

The suite runs several xdist worker processes at once.  With a torch
thread per core in each, every parallel op on the small tensors these
tests use waits at a barrier for threads the other workers hold (the
threefry draws alone ran ~100x slower), so the tests run torch on one
intra-op thread.
"""
import pytest
import torch


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
