"""A module fixture for the port's CPU tests of reduced configs.

Their tensors are too small to split across threads; one intra-op thread
keeps each test process from competing with the others for the cores.
Import ``one_intra_op_thread`` into a test module to apply it there.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the module's tests; the count is restored
    after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
