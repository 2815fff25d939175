"""One PyTorch thread for the port's CPU tests.

The suite runs in several worker processes at once, and PyTorch's
intra-op pool gives each of them a thread for every core of the machine:
the workers then spend most of their time waiting on each other. Measured
on an 8-core machine with 6 workers (``-n 6 --dist loadfile``), the
port's tests took 2,205 worker-seconds with PyTorch's default threads and
810 with one thread each. Every ``tests/test_torch_*.py`` module imports
``one_torch_thread``, an autouse fixture that sets one thread for the
module's tests and its module fixtures and puts the count back after.

The files whose tests write runs and checkpoints (hundreds of MB each:
a fit's checkpoints hold every parameter and two optimizer moments) also
import ``drop_tmp_path``, which deletes a test's ``tmp_path`` after it:
left in place, one run of the suite filled some 9 GB of the temporary
directory's disk, and pytest keeps the last three runs."""
import shutil

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def test_port_tests_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
