"""The LSTM recurrence kernel on the card, against its plain twin.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card. The file imports torch and the port only, so it
runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

Tolerance 1e-5: f32 on both sides (TF32 off), the kernel sums h @ Wh in
another order than torch.bmm."""
import pytest
import torch

from radmmm_torch.ops import lstm_kernel
from radmmm_torch.ops.lstm import MaskedLSTM
from radmmm_torch.ops.lstm_kernel import (lstm_recurrence,
                                          lstm_recurrence_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("L,H,T,B", [(2, 260, 96, 8), (6, 128, 200, 1),
                                     (2, 528, 64, 3), (1, 20, 7, 2)])
def test_kernel_matches_twin(cuda, L, H, T, B):
    g = torch.Generator(device=cuda).manual_seed(0)
    xp = torch.randn((L, T, B, 4 * H), generator=g, device=cuda)
    wh = (torch.rand((L, H, 4 * H), generator=g, device=cuda) * 2 - 1) \
        / H ** 0.5
    lens = torch.tensor([T - i * T // (B + 1) for i in range(B)])
    mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(cuda)
    rev = [bool(l % 2) for l in range(L)]
    before = lstm_kernel.launches
    got = lstm_recurrence(xp, mask, wh, rev)
    assert lstm_kernel.launches == before + 1
    want = lstm_recurrence_reference(xp, mask, wh, rev)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_masked_lstm_on_the_card_matches_the_cpu(cuda):
    torch.manual_seed(0)
    lstm = MaskedLSTM(12, 9, spectral_norm=True)
    x = torch.randn(3, 17, 12)
    mask = torch.arange(17)[None, :] < torch.tensor([[17], [5], [0]])
    with torch.inference_mode():
        want = lstm(x, mask)
        before = lstm_kernel.launches
        got = lstm.to(cuda)(x.to(cuda), mask.to(cuda))
    assert lstm_kernel.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
