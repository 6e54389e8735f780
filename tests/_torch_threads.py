"""One torch thread for the port's CPU tests.

The port's tests run many small tensor operations.  With torch's default
of one intra-op thread a core, several test workers on one machine
oversubscribe the cores, and the threads' spin-waits between operations
slow a small-operation test by up to an order of magnitude (six workers
on eight cores: the port's front-end runs 12x, its manager feeds 4x).
Each port test module imports :func:`one_torch_thread`, which runs the
module's tests with one torch thread and restores the count after them."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
