"""radmmm_torch attention CTC loss: the alpha and beta DP twins (the
plain versions of the CUDA kernels K1 and K2) against the JAX Pallas
kernels in interpret mode, and the loss with its alpha-beta gradient
against the JAX loss and plain autodiff through the JAX scan.

Tolerances: the DPs 1e-5 relative to the magnitude (both sides do the same
f32 lse3 steps; alphas grow to about -100 here, where an f32 ulp is 8e-6);
the loss 1e-6 relative and its gradient 3e-6 absolute, as the JAX package
holds its own custom backward against autodiff (the difference is the
summation order of the posterior fold). The kernels themselves against the
twins on a card: tests/test_torch_kernel_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.losses import ctc as jax_ctc
from radmmm_tpu.losses.ctc_pallas import ctc_alpha_pallas, ctc_beta_pallas
from radmmm_torch.losses import ctc_kernel
from radmmm_torch.losses.ctc import _ctc_setup, attention_ctc_loss
from radmmm_torch.utils.launches import launch_counts
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# (text_lens, mel_lens) on (B, T_mel, T_text) logits: ragged lengths with
# text_len 1, and items with mel_len < text_len (infinite loss, zeroed)
CASES = {
    "ragged": ((4, 28, 9), [9, 6, 2, 1], [28, 19, 8, 3]),
    "mel_shorter_than_text": ((3, 12, 8), [8, 5, 1], [12, 4, 2]),
    "alignment_suite": ((3, 24, 7), [7, 5, 3], [24, 20, 10]),
    "degenerate": ((2, 8, 4), [1, 4], [8, 2]),
    # 89 states: more than two warps of one state a lane in the kernel
    "long_text": ((3, 64, 44), [44, 30, 1], [64, 50, 2]),
}


def _inputs(rng, case):
    (B, T_mel, T_text), tl, ml = CASES[case]
    logits = (rng.standard_normal((B, T_mel, T_text)) * 2).astype(np.float32)
    return logits, np.asarray(tl, np.int32), np.asarray(ml, np.int32)


def _close_band(got, want):
    """Equal within 1e-5 relative where finite; both at the NEG_INF floor
    elsewhere."""
    floor = want < -1e29
    np.testing.assert_array_equal(got < -1e29, floor)
    np.testing.assert_allclose(got[~floor], want[~floor], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "mel_shorter_than_text",
                                  "alignment_suite", "degenerate",
                                  "long_text"])
def test_dp_twins_match_pallas_kernels(rng, case):
    logits, tl, ml = _inputs(rng, case)
    _, emit_j, *_ = jax_ctc._ctc_setup(jnp.asarray(logits), jnp.asarray(tl),
                                       -1.0)
    _, emit, _ = _ctc_setup(torch.from_numpy(logits), torch.from_numpy(tl),
                            -1.0)
    np.testing.assert_allclose(emit.numpy(), np.asarray(emit_j), atol=1e-6)
    args = (jnp.asarray(emit.numpy()), jnp.asarray(tl), jnp.asarray(ml))
    t_args = (emit, torch.from_numpy(tl), torch.from_numpy(ml))
    _close_band(ctc_kernel.ctc_alpha(*t_args).numpy(),
                np.asarray(ctc_alpha_pallas(*args, chunk=8)))
    _close_band(ctc_kernel.ctc_beta(*t_args).numpy(),
                np.asarray(ctc_beta_pallas(*args, chunk=8)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_jax(rng, case):
    """Loss against attention_ctc_loss; the gradient of 3 x loss (a
    non-unit upstream gradient) against autodiff through the JAX scan."""
    logits, tl, ml = _inputs(rng, case)
    j_args = (jnp.asarray(tl), jnp.asarray(ml))
    want = float(jax_ctc.attention_ctc_loss(jnp.asarray(logits), *j_args))
    want_g = np.asarray(jax.grad(lambda a: 3.0 * jax_ctc
                                 .attention_ctc_loss_autodiff(a, *j_args))(
        jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    loss = attention_ctc_loss(x, torch.from_numpy(tl), torch.from_numpy(ml))
    (3.0 * loss).backward()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=3e-6)
    # no gradient past an item's frames or tokens
    for b in range(len(tl)):
        assert np.abs(x.grad[b, ml[b]:].numpy()).max(initial=0) == 0
        assert np.abs(x.grad[b, :, tl[b]:].numpy()).max(initial=0) == 0


def test_zero_infinity_items_get_no_gradient(rng):
    logits, tl, ml = _inputs(rng, "mel_shorter_than_text")
    x = torch.from_numpy(logits).requires_grad_()
    attention_ctc_loss(x, torch.from_numpy(tl), torch.from_numpy(ml)).backward()
    assert np.isfinite(x.grad.numpy()).all()
    assert np.abs(x.grad[1].numpy()).max() == 0      # 5 tokens, 4 frames
    assert np.abs(x.grad[0].numpy()).max() > 0


def test_cpu_tensors_never_launch_the_kernels(rng):
    launch_counts.clear()
    logits, tl, ml = _inputs(rng, "degenerate")
    x = torch.from_numpy(logits).requires_grad_()
    attention_ctc_loss(x, torch.from_numpy(tl), torch.from_numpy(ml)).backward()
    assert not launch_counts


def test_wrappers_reject_bad_inputs():
    emit = torch.zeros(2, 5, 9)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        ctc_kernel.ctc_alpha(emit.double(), lens, lens)
    with pytest.raises(TypeError, match="int32"):
        ctc_kernel.ctc_beta(emit, lens.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        ctc_kernel.ctc_alpha(torch.zeros(2, 9, 5).transpose(1, 2), lens, lens)
    with pytest.raises(ValueError, match="text_lens must be contiguous"):
        ctc_kernel.ctc_alpha(emit, torch.ones(4, dtype=torch.int32)[::2],
                             lens)
