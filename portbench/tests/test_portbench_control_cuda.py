"""The control of each cell on the card: the plain reference computed in
the next lower precision than the configuration states (TF32 for f32
with TF32 off), put in the program's place at the cell's own size, must
come out not correct against the reference, on one of the cell's
numbers. Runs on the card alone:

    python -m pytest portbench/tests/test_portbench_control_cuda.py -m cuda
"""
import pytest
import torch

from portbench import calibrate, harness

CELLS = ["radmmm.train.b8", "radmmm.serve.single"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own "
                    "size")
    harness.tf32_off()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name):
    cell = harness.workload(name)
    fn = (calibrate.train_controls if cell["traffic"]["kind"] == "train"
          else calibrate.serve_controls)
    nums = fn(cell, 2 ** 31 + 3, card, [])["control_tf32"]
    limits = cell["limits"]
    assert any(not harness.judged(k, nums[k], limits[k])["ok"]
               for k in limits), nums
