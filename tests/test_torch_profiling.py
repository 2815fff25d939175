"""radmmm_torch.utils.profiling: the union of overlapping device intervals
(the busy time of a profiled window) and a window's bookkeeping on the
CPU, where no device activity is recorded."""
import os

import pytest
import torch

from radmmm_torch.utils.profiling import StepProfiler, union_length
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(5, 12), (0, 10)], 12.0),                  # overlapping, unsorted
    ([(0, 10), (2, 3), (20, 25), (24, 30)], 20.0),  # nested and chained
    ([(0, 1), (1, 2)], 2.0),                     # touching
])
def test_union_length(spans, want):
    assert union_length(spans) == want


def test_window_records_its_steps(tmp_path):
    prof = StepProfiler(str(tmp_path), 1, 2, torch.device("cpu"))
    x = torch.randn(64, 64)
    for step in range(4):
        prof.before(step)
        x = torch.tanh(x @ x)
        prof.after(step)
        assert bool(prof.stats) == (step >= 2)
    st = prof.stats
    assert st["profile_steps"] == 2 and st["profile_wall_s"] > 0
    assert st["profile_busy_s"] == st["profile_kernel_s"] == 0.0
    assert os.path.exists(tmp_path / "trace.json")


def test_off_without_a_directory():
    prof = StepProfiler(None, 0, 1, torch.device("cpu"))
    prof.before(0)
    prof.after(0)
    prof.stop()
    assert prof.stats == {}
