"""K5, the fused dilated conv + softplus of the WN stack, and the port's
bench entry point, against ``scripts/bench_wn_kernel.py``.

The script's Pallas kernel runs on the CPU in TPU interpret mode
(``force_tpu_interpret_mode``), as it refuses the CPU otherwise; the port's
wrapper runs its plain twin on CPU tensors. The script is loaded from its
file; it imports only numpy at module level.

Tolerances: the twin against the Pallas kernel and the fused stack against
the Pallas stack 1e-5 absolute (the same bf16-rounded inputs, f32 sums in
another order; in the stack a product that lands within an f32 rounding
of a bf16 rounding boundary, where the next layer's input or a res_skip
output is rounded, would move by a bf16 ulp, as one of 8,192 did with
other draws of these weights); variants A and B against the script's within bf16
rounding, 2e-2 absolute (each rounds every conv and res_skip output to
bf16, 2^-9 relative of values up to about 4, through four layers)."""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from radmmm_torch.ops import wn_kernel
from radmmm_torch.scripts import bench_wn_kernel as wn
from radmmm_torch.utils.launches import launch_counts
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_bench_wn_kernel", REPO / "scripts" / "bench_wn_kernel.py")
jax_wn = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_wn)


def _layer(rng, C):
    """A (K, C, C) conv weight and a bias."""
    return ((rng.standard_normal((wn.K, C, C)) * 0.02).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32))


def _stack_params(rng, C):
    """Four (wc, bc, wr, br) layers at width C with non-zero biases; the
    1x1 weight wr is the first tap of a second conv weight."""
    out = []
    for _ in wn.DILATIONS:
        wc, bc = _layer(rng, C)
        wr, br = _layer(rng, C)
        out.append((wc, bc, wr[0], br))
    return out


@pytest.mark.parametrize("dilation", wn.DILATIONS)
def test_twin_matches_the_pallas_kernel(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    w, b = _layer(rng, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_wn.pallas_conv_softplus(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation,
            block_cout=64))
    launch_counts.clear()
    got = wn_kernel.conv_softplus(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), dilation)
    assert not launch_counts                  # the CPU runs the twin
    assert got.dtype == torch.float32 and got.shape == (2, 16, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_fused_stack_matches_the_pallas_stack():
    """Variant C against the script's wn_stack_pallas at C 512, the
    smallest width its block_cout=512 takes."""
    rng = np.random.default_rng(5)
    params = _stack_params(rng, 512)
    x = rng.standard_normal((1, 16, 512)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_wn.wn_stack_pallas(
            [tuple(jnp.asarray(a) for a in p) for p in params],
            jnp.asarray(x))
    got = wn.wn_stack_fused(
        [tuple(torch.from_numpy(a) for a in p) for p in params],
        torch.from_numpy(x))
    for g, w_, name in zip(got, want, ("h", "skip")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("variant", ["A", "B"])
def test_unfused_stacks_match_the_script_within_bf16(variant):
    """A (cuDNN's conv on the card) against conv_lax, B against the
    script's shifted matmuls; both round every conv output to bf16."""
    conv, jax_conv = {"A": (wn.conv_cudnn, jax_wn.conv_lax),
                      "B": (wn.conv_matmul, jax_wn.conv_matmul)}[variant]
    rng = np.random.default_rng(7)
    params = _stack_params(rng, 128)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    want = jax_wn.wn_stack(jax_conv,
                           [tuple(jnp.asarray(a) for a in p) for p in params],
                           jnp.asarray(x))
    got = wn.wn_stack(conv,
                      [tuple(torch.from_numpy(a) for a in p) for p in params],
                      torch.from_numpy(x))
    for g, w_, name in zip(got, want, ("h", "skip")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-2,
                                   rtol=0, err_msg=name)


def test_make_params_draws_the_scripts_weights():
    """Bit for bit: the same numbers from the same seeded generator, and
    the same constants and FLOP count."""
    want = jax_wn.make_params(np.random.default_rng(0))
    got = wn.make_params(np.random.default_rng(0))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (wn.C, wn.K, wn.DILATIONS) == (jax_wn.C, jax_wn.K,
                                          jax_wn.DILATIONS)
    assert wn.stack_flops(32, 256) == jax_wn.stack_flops(32, 256)


@pytest.mark.parametrize("x_shape,w_shape,b_shape,dilation,match", [
    ((2, 8, 12), (5, 12, 16), (16,), 1, "multiples of 8"),
    ((2, 8, 16), (5, 16, 20), (20,), 1, "multiples of 8"),
    ((2, 8, 16), (4, 16, 16), (16,), 1, "odd kernel size"),
    ((2, 8, 16), (5, 16, 16), (16,), 0, "dilation"),
    ((2, 8, 16), (5, 24, 16), (16,), 1, "do not agree"),
    ((2, 8, 16), (5, 16, 16), (8,), 1, "do not agree"),
    ((8, 16), (5, 16, 16), (16,), 1, r"\(B, T, Cin\)"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(
        x_shape, w_shape, b_shape, dilation, match):
    with pytest.raises(ValueError, match=match):
        wn_kernel.conv_softplus(torch.zeros(x_shape), torch.zeros(w_shape),
                                torch.zeros(b_shape), dilation)


def test_wrapper_refuses_integer_inputs():
    with pytest.raises(TypeError, match="float"):
        wn_kernel.conv_softplus(torch.zeros((1, 4, 8), dtype=torch.int32),
                                torch.zeros((5, 8, 8)), torch.zeros(8), 1)


def test_softplus_is_the_stable_form_of_jax():
    v = torch.tensor([-100.0, -20.5, -1.0, 0.0, 1e-3, 19.9, 20.5, 88.0])
    np.testing.assert_allclose(wn_kernel.softplus(v).numpy(),
                               np.asarray(jax.nn.softplus(v.numpy())),
                               rtol=1e-6, atol=1e-30)


def test_entry_point_runs_on_the_cpu_and_refuses_a_missing_card(capsys):
    res = wn.main(["--batch", "1", "--t", "4", "--iters", "1",
                   "--device", "cpu"])
    assert res["device"] == "cpu"
    for v in ("A_cudnn_conv", "B_shift_matmul", "C_cuda_fused"):
        assert res[f"wn_fwd_{v}_ms"] > 0
    assert {"wn_grad_A_cudnn_conv_ms", "wn_grad_B_shift_matmul_ms"} <= set(res)
    assert res["err_A_C_h"] < 2e-2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == pytest.approx(res)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wn.main(["--device", "cuda"])
