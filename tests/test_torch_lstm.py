"""radmmm_torch LSTM recurrence: the kernel's plain twin against the JAX
Pallas kernel (interpret mode) and the ganged scan, MaskedLSTM with
spectral norm against the JAX module; the recurrence's gradients (the
plain BPTT twin of the backward kernel, through the autograd Function)
against jax.grad through the JAX scan. The kernels themselves against the
twins on a card: tests/test_torch_kernel_cuda.py.

Tolerance 1e-5 throughout: both sides run the same f32 recurrence
(matmul precision 'highest' in JAX, full f32 in torch on the CPU), and
the difference is summation order only."""
import dataclasses

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
                                          lstm_recurrence_backward_reference,
                                          lstm_recurrence_reference)
from radmmm_torch.utils.launches import launch_counts
from tests.test_torch_convert import perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

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
    launch_counts.clear()
    x = torch.from_numpy(rng.standard_normal((2, 7, 4)).astype(np.float32))
    MaskedLSTM(4, 3)(x, torch.ones(2, 7))
    assert not launch_counts


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


def _gang_inputs(rng, P=3, B=3, T=11, C=5, H=6):
    xs = rng.standard_normal((P, B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[11], [7], [1]])).astype(
        np.float32)
    wi = (rng.standard_normal((P, C, 8 * H)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((P, 2, H, 4 * H)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((P, 2, 4 * H)) * 0.1).astype(np.float32)
    return xs, mask, wi, wh, bias


def test_gradients_match_jax_grad_through_the_scan(rng):
    """P=3 ganged BiLSTMs: d/d(xs, wi, wh, bias) of a weighted sum of the
    outputs, through the Function (BPTT twin + one bmm for dWh) against
    jax.grad through multi_bilstm_scan."""
    args = _gang_inputs(rng)
    w = rng.standard_normal((3, 3, 11, 12)).astype(np.float32)
    want = jax.grad(
        lambda xs, wi, wh, b: jnp.sum(jax_multi_bilstm_scan(
            xs, jnp.asarray(args[1]), wi, wh, b) * w),
        argnums=(0, 1, 2, 3))(*[jnp.asarray(args[i]) for i in (0, 2, 3, 4)])
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 3, 4):
        t[i].requires_grad_()
    (multi_bilstm_scan(*t) * torch.from_numpy(w)).sum().backward()
    for g_want, i in zip(want, (0, 2, 3, 4)):
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(g_want),
                                   atol=ATOL)


def test_bptt_twin_with_a_mask_that_is_not_a_prefix(rng):
    """Masked frames inside a sequence pass dh and dc through and give
    zero gate gradients: the twin against autograd through the forward
    twin's own ops."""
    x_proj, mask, wh = _ragged(rng)
    mask[4, 0] = mask[9, 1] = 0.0
    xp = torch.from_numpy(x_proj)[None].repeat(2, 1, 1, 1)
    whs = torch.from_numpy(wh)[None].repeat(2, 1, 1)
    m = torch.from_numpy(mask)
    rev = [False, True]
    dout = torch.from_numpy(rng.standard_normal(
        (2, *x_proj.shape[:2], wh.shape[0])).astype(np.float32))
    xp_a = xp.clone().requires_grad_()
    (lstm_recurrence_reference(xp_a, m, whs, rev) * dout).sum().backward()
    _, act, cs, _ = lstm_recurrence_reference(xp, m, whs, rev, save=True)
    got = lstm_recurrence_backward_reference(dout, act, cs, m, whs, rev)
    np.testing.assert_allclose(got.numpy(), xp_a.grad.numpy(), atol=ATOL)
    assert got[0, 4, 0].abs().max() == 0 and got[1, 9, 1].abs().max() == 0


@pytest.mark.parametrize("bidirectional", [True, False])
def test_masked_lstm_training_matches_jax(rng, bidirectional):
    """update_sn=True: the output, the u written back to the spectral
    state, and the gradients of every weight (sigma's gradient through W
    only) against jax.grad of the JAX module."""
    B, T, C, H = 2, 9, 6, 5
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0
    w = rng.standard_normal((B, T, H * (2 if bidirectional else 1))).astype(
        np.float32)
    mod = JaxMaskedLSTM(H, bidirectional=bidirectional, spectral_norm=True)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(x),
                                 jnp.asarray(mask)))

    def loss(params):
        y, mut = mod.apply({"params": params,
                            "spectral": variables["spectral"]},
                           jnp.asarray(x), jnp.asarray(mask), True,
                           mutable=["spectral"])
        return jnp.sum(y * w), mut

    (_, mut), g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    port = MaskedLSTM(C, H, bidirectional=bidirectional, spectral_norm=True)
    port.load_state_dict(tts_state_dict_from_jax(variables))
    (port(torch.from_numpy(x), torch.from_numpy(mask), update_sn=True)
     * torch.from_numpy(w)).sum().backward()
    want_u = tts_state_dict_from_jax({"spectral": mut["spectral"]})
    for k, v in want_u.items():
        np.testing.assert_allclose(port.get_buffer(k).numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)
    want_g = tts_state_dict_from_jax({"params": g})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=ATOL, err_msg=name)


def test_serving_call_writes_nothing_for_the_backward(rng):
    """Without autograd the recurrence is the plain forward: no grad_fn,
    and a spectral norm's u is left alone."""
    lstm = MaskedLSTM(4, 3, spectral_norm=True)
    u = lstm.sn_fwd.u.clone()
    x = torch.from_numpy(rng.standard_normal((2, 7, 4)).astype(np.float32))
    with torch.inference_mode():
        y = lstm(x, torch.ones(2, 7))
    assert y.grad_fn is None
    assert torch.equal(lstm.sn_fwd.u, u)
    lstm(x, torch.ones(2, 7), update_sn=True)
    assert not torch.equal(lstm.sn_fwd.u, u)


# an H100 SXM's limits for the kernels' plans; regs_per_thread 0 leaves
# registers out of the grid route's residency
H100 = lstm_kernel.CardLimits(sms=132, smem_per_block=232448,
                              smem_per_sm=233472, regs_per_thread=0,
                              max_cluster=16)


def _check_plan(threads, smem_fn, plan, L, B, H, route):
    """What every plan of a kernel with ``threads`` a CTA and shared memory
    ``smem_fn`` keeps: each unit owned, one cell per thread, the shared
    memory within a block's, a grid resident at once."""
    assert plan.n_cta * plan.hb >= H > (plan.n_cta - 1) * plan.hb
    assert B * plan.hb <= threads
    assert plan.smem == smem_fn(B, H, plan.hb, plan.ks, plan.n_cta,
                                route == "cluster")
    assert plan.smem <= H100.smem_per_block
    if route == "grid":
        assert L * plan.n_cta <= H100.sms * (
            H100.smem_per_sm // (plan.smem + 1024))


@pytest.mark.parametrize("L,B,H,route,n_cta,hb,ks,max_cluster", [
    (2, 8, 260, "cluster", 16, 17, 2, 16),     # text encoder
    (2, 8, 128, "cluster", 16, 8, 2, 16),      # duration DAP
    (6, 8, 128, "cluster", 16, 8, 2, 16),      # frame DAPs, ganged
    (2, 8, 528, "grid", 66, 8, 1, 16),         # flow context: Wh 4.46 MB
    (2, 8, 260, "cluster", 8, 33, 2, 8),       # portable clusters only
    (1, 3, 20, "cluster", 10, 2, 2, 16),
    (2, 24, 260, "grid", 33, 8, 1, 16)])       # 24 x 17 cells > threads
def test_backward_plan_picks_route_and_sizes(L, B, H, route, n_cta, hb, ks,
                                             max_cluster):
    """The backward kernel's plan on an H100's limits (227 KB of shared
    memory a block, 132 SMs, clusters of up to 16 CTAs or the portable 8):
    the largest cluster per lane where the lane's Wh slices fit, else the
    cooperative grid; every unit owned, one cell per thread, the shared
    memory within a block's."""
    limits = dataclasses.replace(H100, max_cluster=max_cluster)
    plan = lstm_kernel.backward_plan(L, B, H, limits)
    assert (plan.route, plan.n_cta, plan.hb, plan.ks) == (route, n_cta, hb,
                                                          ks)
    _check_plan(lstm_kernel._BWD_THREADS, lstm_kernel._bwd_smem, plan, L, B,
                H, route)


@pytest.mark.parametrize("L,B,H,route,n_cta,hb,ks,max_cluster", [
    (2, 8, 260, "cluster", 16, 17, 7, 16),     # text encoder: 7 x 34 threads
    (2, 8, 128, "cluster", 16, 8, 8, 16),      # duration DAP
    (6, 8, 128, "cluster", 16, 8, 8, 16),      # frame DAPs, ganged
    (12, 8, 128, "cluster", 16, 8, 8, 16),     # more lanes than fit at once
    (2, 8, 528, "grid", 66, 8, 8, 16),         # flow context: Wh 4.46 MB
    (2, 1, 528, "grid", 66, 8, 8, 16),         # its Wh slice past a block
    (6, 1, 128, "cluster", 16, 8, 8, 16),      # the serving frame bucket
    (2, 1, 260, "cluster", 8, 33, 3, 8),       # portable clusters only
    (2, 8, 260, "grid", 33, 8, 8, 8),          # 8 x 33 cells > threads
    (1, 3, 20, "cluster", 10, 2, 8, 16),
    (2, 24, 260, "grid", 33, 8, 8, 16)])       # 24 x 17 cells > threads
def test_forward_plan_picks_route_and_sizes(L, B, H, route, n_cta, hb, ks,
                                            max_cluster):
    """The forward kernel's plan on an H100's limits: a cluster per lane
    where the lane's Wh slices fit (H <= 260 in the model), else the
    cooperative grid with a barrier per lane (H = 528); the H reduction in
    8 chunks, as far as two columns a thread allow."""
    limits = dataclasses.replace(H100, max_cluster=max_cluster)
    plan = lstm_kernel.forward_plan(L, B, H, limits)
    assert (plan.route, plan.n_cta, plan.hb, plan.ks) == (route, n_cta, hb,
                                                          ks)
    _check_plan(lstm_kernel._FWD_THREADS, lstm_kernel._fwd_smem, plan, L, B,
                H, route)
    assert 2 * plan.hb * plan.ks <= lstm_kernel._FWD_THREADS
    assert plan.ks * -(-H // plan.ks) >= H


NOTHING_FITS = [(8, 8, 1024, H100),
                (2, 8, 528, dataclasses.replace(H100, sms=16)),
                (1, 385, 4, H100)]


@pytest.mark.parametrize("L,B,H,limits", NOTHING_FITS)
def test_backward_plan_raises_when_nothing_fits(L, B, H, limits):
    """No cluster holds the slices and no grid of them is resident at
    once (or a single unit's cells outnumber the threads): the plan
    raises rather than launch something that would hang or fail."""
    with pytest.raises(RuntimeError, match=r"\(bwd\): no route fits"):
        lstm_kernel.backward_plan(L, B, H, limits)


@pytest.mark.parametrize("L,B,H,limits", NOTHING_FITS)
def test_forward_plan_raises_when_nothing_fits(L, B, H, limits):
    """The forward's plan raises where the backward's does."""
    with pytest.raises(RuntimeError, match=r"\(fwd\): no route fits"):
        lstm_kernel.forward_plan(L, B, H, limits)


def test_forward_plan_raises_past_its_threads():
    """257 cells of one unit outnumber the forward's 256 threads (the
    backward's 384 still hold them)."""
    with pytest.raises(RuntimeError, match="no route fits"):
        lstm_kernel.forward_plan(1, 257, 4, H100)
    assert lstm_kernel.backward_plan(1, 257, 4, H100).route == "cluster"


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_sweep_script_refuses_a_missing_card(direction):
    """The plan sweep times kernels on the card only."""
    from radmmm_torch.scripts import sweep_lstm
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_lstm.main(["--direction", direction, "--shapes", "1x8x4x2"])
