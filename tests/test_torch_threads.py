"""One PyTorch thread for the port's CPU tests.

The suite runs in several worker processes at once, and PyTorch's
intra-op pool gives each of them a thread for every core of the machine:
the workers then spend most of their time waiting on each other. Measured
on an 8-core machine with 6 workers (``-n 6 --dist loadfile``), the
port's tests took 2,205 worker-seconds with PyTorch's default threads and
810 with one thread each. Every ``tests/test_torch_*.py`` module imports
``one_torch_thread``, an autouse fixture that sets one thread for the
module's tests and its module fixtures and puts the count back after."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_tests_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
