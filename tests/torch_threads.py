"""One intra-op thread for a port test module's torch work.

The suite runs in several pytest workers on one host (``-n 6``); torch's
default of a thread per core then oversubscribes the CPU, and small
training steps wait on each other's threads (tests/test_torch_adv_aug.py
measured a 1 s run taking 100 s). A module imports the fixture to pin
one thread for its tests and restore the count after:

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
