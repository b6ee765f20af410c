"""The port's test files run torch on one thread: their eager ops are
small, and with several test workers on the machine torch's intra-op
thread pool only adds contention (tens of times the run time under
load). A test file imports the fixture to use it::

    from torch_threads import _one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
