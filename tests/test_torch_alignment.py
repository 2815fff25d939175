"""radmmm_torch width-1 MAS: the plain twin of the CUDA kernel K3 against
the JAX ``mas_width1`` under both of its backends (the lax.scan path and
the Pallas kernel in interpret mode) and against the numpy oracle, bit for
bit: every value is the same f32 add and every choice the same compare.
The kernel itself against the twin on a card:
tests/test_torch_kernel_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.ops import alignment as jax_alignment
from radmmm_torch.ops.alignment import (binarize_attention, mas_width1,
                                        mas_width1_ref)
from radmmm_torch.utils.launches import launch_counts
from tests.test_alignment import soft_attn
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# (B, T_mel, T_text), text_lens, mel_lens: the JAX suite's cases (the
# oracle case, text_len 1 and mel_len 1, the Pallas comparison's padded
# lanes and short lengths)
CASES = {
    "oracle": ((3, 37, 11), [11, 7, 5], [37, 25, 12]),
    "degenerate": ((3, 10, 5), [1, 5, 3], [10, 1, 3]),
    "pallas_suite": ((3, 40, 17), [17, 9, 1], [40, 23, 5]),
    # more than 32 text columns (the kernel's 2 columns a lane), ragged
    "wide_ragged": ((3, 70, 45), [45, 33, 2], [70, 52, 9]),
}


def _inputs(rng, case):
    (B, T_mel, T_text), tl, ml = CASES[case]
    return (soft_attn(rng, B, T_mel, T_text), np.asarray(tl, np.int32),
            np.asarray(ml, np.int32))


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_jax_mas(rng, case, backend):
    attn, tl, ml = _inputs(rng, case)
    try:
        jax_alignment.set_mas_backend(backend)
        want = np.asarray(jax_alignment.mas_width1(
            jnp.asarray(attn), jnp.asarray(tl), jnp.asarray(ml)))
    finally:
        jax_alignment.set_mas_backend("auto")
    got = mas_width1(torch.from_numpy(attn), torch.from_numpy(tl),
                     torch.from_numpy(ml)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_numpy_oracle(rng, case):
    attn, tl, ml = _inputs(rng, case)
    got = mas_width1(torch.from_numpy(attn), torch.from_numpy(tl),
                     torch.from_numpy(ml)).numpy()
    for b in range(len(tl)):
        want = mas_width1_ref(attn[b, :ml[b], :tl[b]])
        np.testing.assert_array_equal(got[b, :ml[b], :tl[b]], want,
                                      err_msg=f"item {b}")
        assert got[b, ml[b]:].sum() == 0 and got[b, :, tl[b]:].sum() == 0


def test_port_oracle_equals_the_jax_oracle(rng):
    attn = soft_attn(rng, 1, 13, 6)[0]
    np.testing.assert_array_equal(mas_width1_ref(attn),
                                  jax_alignment.mas_width1_ref(attn))


def test_ties_prefer_the_diagonal():
    """Uniform attention: every compare is a tie."""
    attn = np.full((1, 9, 4), 0.25, np.float32)
    got = mas_width1(torch.from_numpy(attn), torch.tensor([4], dtype=torch.int32),
                     torch.tensor([9], dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got[0], mas_width1_ref(attn[0]))


def test_empty_items_are_zero(rng):
    """No frames, or no text: an all-zero alignment, as the scan path."""
    attn = soft_attn(rng, 2, 6, 4)
    tl, ml = np.array([3, 0], np.int32), np.array([0, 6], np.int32)
    got = mas_width1(torch.from_numpy(attn), torch.from_numpy(tl),
                     torch.from_numpy(ml)).numpy()
    assert got.sum() == 0
    want = np.asarray(jax_alignment.mas_width1(
        jnp.asarray(attn), jnp.asarray(tl), jnp.asarray(ml)))
    np.testing.assert_array_equal(got, want)


def test_binarize_attention_is_detached_and_counts_nothing_on_cpu(rng):
    launch_counts.clear()
    attn, tl, ml = _inputs(rng, "oracle")
    soft = torch.from_numpy(attn).requires_grad_()
    hard = binarize_attention(soft, torch.from_numpy(tl).long(),
                              torch.from_numpy(ml).long())
    assert not hard.requires_grad
    assert not launch_counts
