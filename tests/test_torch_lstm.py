"""radmmm_torch LSTM recurrence: the kernel's plain twin against the JAX
Pallas kernel (interpret mode) and the ganged scan, MaskedLSTM with
spectral norm against the JAX module. The kernel itself against the twin
on a card: tests/test_torch_kernel_cuda.py.

Tolerance 1e-5 throughout: both sides run the same f32 recurrence
(matmul precision 'highest' in JAX, full f32 in torch on the CPU), and
the difference is summation order only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.ops.lstm import MaskedLSTM as JaxMaskedLSTM
from radmmm_tpu.ops.lstm import multi_bilstm_scan as jax_multi_bilstm_scan
from radmmm_tpu.ops.lstm_pallas import lstm_recurrence_pallas
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.ops import lstm_kernel
from radmmm_torch.ops.lstm import MaskedLSTM, multi_bilstm_scan
from radmmm_torch.ops.lstm_kernel import (lstm_recurrence,
                                          lstm_recurrence_reference)
from tests.test_torch_convert import perturb

ATOL = 1e-5


def _ragged(rng, T=23, B=4, H=8, lengths=(23, 17, 0, 5)):
    x_proj = (rng.standard_normal((T, B, 4 * H)) * 0.5).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(
        np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32)
    return x_proj, mask, wh


@pytest.mark.parametrize("reverse", [False, True])
def test_twin_matches_pallas_kernel(rng, reverse):
    """Ragged masks with a zero-length item, T=23 not a multiple of the
    Pallas chunk (8). A reverse lane equals the Pallas kernel run on the
    time-flipped sequence, flipped back."""
    x_proj, mask, wh = _ragged(rng)
    if reverse:
        want = np.asarray(lstm_recurrence_pallas(
            jnp.asarray(x_proj[::-1].copy()), jnp.asarray(mask[::-1].copy()),
            jnp.asarray(wh), chunk=8, interpret=True))[::-1]
    else:
        want = np.asarray(lstm_recurrence_pallas(
            jnp.asarray(x_proj), jnp.asarray(mask), jnp.asarray(wh), chunk=8,
            interpret=True))
    got = lstm_recurrence_reference(
        torch.from_numpy(x_proj)[None], torch.from_numpy(mask),
        torch.from_numpy(wh)[None], [reverse])[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[:, 2] == 0)          # the zero-length item


def test_multi_lane_matches_multi_bilstm_scan(rng):
    """P=3 ganged BiLSTMs (6 lanes, one recurrence call) against the JAX
    fused scan."""
    P, B, T, C, H = 3, 3, 11, 5, 6
    xs = rng.standard_normal((P, B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[11], [7], [1]])).astype(
        np.float32)
    wi = (rng.standard_normal((P, C, 8 * H)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((P, 2, H, 4 * H)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((P, 2, 4 * H)) * 0.1).astype(np.float32)
    want = np.asarray(jax_multi_bilstm_scan(
        *[jnp.asarray(a) for a in (xs, mask, wi, wh, bias)]))
    got = multi_bilstm_scan(*[torch.from_numpy(a)
                              for a in (xs, mask, wi, wh, bias)]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_masked_lstm_with_spectral_norm_matches_jax(rng, bidirectional):
    """Copied weights and `spectral` state; update_sn=False on the JAX side
    (one power iteration from the stored u, u unchanged)."""
    B, T, C, H = 2, 9, 6, 5
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0
    mod = JaxMaskedLSTM(H, bidirectional=bidirectional, spectral_norm=True)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(x),
                                 jnp.asarray(mask)))
    assert "spectral" in variables
    want = np.asarray(mod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                False))
    port = MaskedLSTM(C, H, bidirectional=bidirectional, spectral_norm=True)
    port.load_state_dict(tts_state_dict_from_jax(variables))
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_cpu_tensors_never_launch_the_kernel(rng):
    lstm_kernel.launches = 0
    x = torch.from_numpy(rng.standard_normal((2, 7, 4)).astype(np.float32))
    MaskedLSTM(4, 3)(x, torch.ones(2, 7))
    assert lstm_kernel.launches == 0


def test_wrapper_rejects_bad_inputs():
    xp = torch.zeros(2, 5, 3, 16)
    wh = torch.zeros(2, 4, 16)
    mask = torch.ones(5, 3)
    with pytest.raises(TypeError, match="float32"):
        lstm_recurrence(xp.double(), mask, wh, [False, True])
    with pytest.raises(ValueError, match="lanes"):
        lstm_recurrence(xp, mask, wh, [False])
    with pytest.raises(ValueError, match="lanes"):
        lstm_recurrence(xp, torch.ones(4, 3), wh, [False, True])
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence(torch.zeros(2, 3, 5, 16).transpose(1, 2), mask, wh,
                        [False, True])
    # per-lane masks are accepted
    out = lstm_recurrence(xp, torch.ones(2, 5, 3), wh, [False, True])
    assert out.shape == (2, 5, 3, 4)
