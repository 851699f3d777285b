"""One intra-op thread for the port's CPU tests.

A test module that imports :func:`one_intra_op_thread` runs its tests and
its module fixtures on one torch thread. The port's CPU runs are many
small operations (64x48 frames): torch splits each over a pool of one
thread per core, whose threads wait on each other, and beside the
suite's other worker processes those cores are busy. There one case took
34.8 s on the default pool and 1.2 s on one thread
(``test_torch_fidelity.py::test_main_writes_the_record``, beside seven
busy processes on an 8-core host).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the module's tests, restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
