"""radmmm_torch's ``conv_precision: bf16`` against the JAX package's.

What JAX computes on this CPU (measured here: ``test_jax_default_
precision_is_f32_on_this_cpu``): its convolutions cast both operands to
bf16 and ask for a bf16 output (``radmmm_tpu/ops/conv.py:61-96``), so they
are bf16 on the CPU too; its LSTM einsums at ``Precision.DEFAULT`` are
full f32 on the CPU (bf16 operands only on a TPU). So:

* ``MaskedConv1d`` (plain, dilated, partial padding, weight norm) is held
  to JAX's under ``set_conv_precision("bf16")`` within one bf16 ulp of the
  output (rtol 2^-7 of each value, atol 2^-8 of the output's largest
  magnitude, since partial padding scales and the bias offsets a value
  after its rounding);
* the bf16 recurrence twin (``lstm_kernel``, forward and backward) is held
  tightly (rtol 1e-5, atol 1e-6: f32 sums in another order) to a numpy
  reference with exactly its semantics (h and Wh, and in the backward
  dgates and Wh, rounded to bf16 before each product, f32 sums), and at a
  measured tolerance (BF16_LSTM_*, 4-6 times the errors read here) to
  JAX's f32 scans in bf16 mode and to the Pallas kernel in interpret mode
  at ``Precision.DEFAULT``: the gap is the rounding of h and Wh itself;
* one training step of the tests' tiny model (every dropout rate at 0) in
  bf16 mode, the port against JAX: loss terms within BF16_LOSS_RTOL, the
  whole gradient tree and the median leaf by Frobenius norm within
  BF16_GRAD_RTOL and every leaf within BF16_LEAF_RTOL (each measured
  here, see the constants), while the port in f32 mode misses JAX's bf16
  loss terms by more;
* the plans of the bf16 kernels at the model's shapes, the trainer and
  ``cli fit`` in bf16 on the CPU, the serving artifact's precision (the
  loading process's setting) and the import-time environment variables.

The switch is process-wide in both packages: every test that sets it
puts f32 back (the ``bf16`` fixture)."""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.ops import conv as jconv
from radmmm_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from radmmm_tpu.ops.lstm import multi_bilstm_scan as jax_multi_bilstm_scan
from radmmm_tpu.ops.lstm_pallas import lstm_recurrence_pallas
from radmmm_tpu.training import step as jax_step
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.ops import conv as pconv
from radmmm_torch.ops import lstm_kernel as lk
from radmmm_torch.ops.lstm import multi_bilstm_scan
from radmmm_torch.serving import export_tts, load_tts
from radmmm_torch.training import cli as torch_cli
from radmmm_torch.training import step
from tests.test_torch_convert import perturb
from tests.test_torch_fit import cfg_files  # noqa: F401 (a fixture)
from tests.test_torch_lstm import H100
from tests.test_torch_training import REG, _no_dropout_config
from tests.test_tts_model import tiny_batch
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bf16 twins against JAX's f32 scans: read here 2.34e-3 on the outputs
# and 3.38e-3 on the inputs' gradient
BF16_LSTM_ATOL = 1e-2
BF16_LSTM_GRAD_RTOL = 2e-2
# one training step, bf16 port against bf16 JAX: read here 8.47e-4 on the
# loss terms (relative), 2.80e-3 for the median leaf and 1.78e-3 for the
# whole gradient tree by Frobenius norm, and 0.348 for the worst leaf
# (text_encoder.norm_0.bias). The leaves of the text encoder's convs and
# norms and of a DAP's bottleneck sit 0.1-0.35 apart because their
# gradients are near-cancelling sums through leaky-ReLU kinks: JAX's own
# bf16 step sits 0.34 from its f32 step on the same leaves
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_RTOL = 1e-2
BF16_LEAF_RTOL = 0.5


@pytest.fixture
def bf16():
    jconv.set_conv_precision("bf16")
    pconv.set_conv_precision("bf16")
    try:
        yield
    finally:
        jconv.set_conv_precision("f32")
        pconv.set_conv_precision("f32")


def test_jax_default_precision_is_f32_on_this_cpu(rng):
    """The premise of the tolerances: XLA's CPU dot at DEFAULT equals
    HIGHEST (f32), and a bf16 cast conv differs from the f32 one."""
    a = rng.standard_normal((8, 64)).astype(np.float32)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    d, h = (np.asarray(jnp.dot(a, b, precision=p)) for p in (
        jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST))
    np.testing.assert_array_equal(d, h)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    k = rng.standard_normal((3, 8, 4)).astype(np.float32)
    f32 = np.asarray(jconv.conv1d_same(x, k))
    jconv.set_conv_precision("bf16")
    try:
        low = np.asarray(jconv.conv1d_same(x, k))
    finally:
        jconv.set_conv_precision("f32")
    assert 0 < np.abs(low - f32).max() <= 2 ** -7 * np.abs(f32).max()


# --- MaskedConv1d --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(kernel_size=5, dilation=2),
    dict(kernel_size=3, use_partial_padding=True),
    dict(kernel_size=3, use_weight_norm=True, dilation=4),
    dict(kernel_size=5, use_partial_padding=True, use_weight_norm=True)],
    ids=["plain", "dilated", "partial", "wnorm", "partial_wnorm"])
def test_masked_conv_bf16_matches_jax(rng, bf16, kw):
    kw = {"kernel_size": 1, **kw}
    x = rng.standard_normal((3, 20, 12)).astype(np.float32)
    mask = (np.arange(20)[None] < np.asarray([[20], [13], [6]])).astype(
        np.float32)
    jm = jconv.MaskedConv1d(10, **kw)
    v = jm.init(jax.random.key(0), x, mask)
    v = perturb(v)
    want = np.asarray(jm.apply(v, x, mask))
    p = v["params"]
    port = pconv.MaskedConv1d(12, 10, **kw)
    with torch.no_grad():
        if kw.get("use_weight_norm"):
            port.v.copy_(torch.from_numpy(p["v"].transpose(2, 1, 0).copy()))
            port.g.copy_(torch.from_numpy(p["g"]))
        else:
            port.weight.copy_(torch.from_numpy(
                p["kernel"].transpose(2, 1, 0).copy()))
        port.bias.copy_(torch.from_numpy(p["bias"]))
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())
    with torch.no_grad():
        pconv.set_conv_precision("f32")
        f32 = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.abs(f32 - want).max() > 0          # bf16 did round


def test_bf16_products_round_their_operands(rng):
    """``matmul`` and the no-cast conv (RADMMM_BF16_CAST=0): bf16-rounded
    operands, f32 sums and results, forward and backward, against the f32
    ops on the rounded operands."""
    r = pconv.bf16_round
    x = torch.from_numpy(rng.standard_normal((2, 9, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    pconv.set_conv_precision("bf16")
    try:
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = pconv.matmul(xg, wg)
        y.backward(dy)
        xc = torch.from_numpy(rng.standard_normal((2, 7, 16)).astype(
            np.float32)).requires_grad_()
        wc = torch.from_numpy(rng.standard_normal((4, 7, 3)).astype(
            np.float32)).requires_grad_()
        old, pconv._BF16_CAST = pconv._BF16_CAST, False
        try:
            yc = pconv.conv1d(xc, wc, padding=2, dilation=2)
        finally:
            pconv._BF16_CAST = old
        dyc = torch.randn(yc.shape)
        yc.backward(dyc)
    finally:
        pconv.set_conv_precision("f32")
    assert y.dtype == yc.dtype == torch.float32
    torch.testing.assert_close(y, r(x) @ r(w), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xg.grad, r(dy) @ r(w).t(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(
        wg.grad, r(x).reshape(-1, 7).t() @ r(dy).reshape(-1, 5), rtol=1e-6,
        atol=1e-6)
    xr, wr = r(xc.detach()).requires_grad_(), r(wc.detach()).requires_grad_()
    want = torch.nn.functional.conv1d(xr, wr, padding=2, dilation=2)
    want.backward(r(dyc))
    torch.testing.assert_close(yc, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xc.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wc.grad, wr.grad, rtol=1e-6, atol=1e-6)


# --- the bf16 recurrence --------------------------------------------------

def _np_bf16(x):
    """numpy float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _sig(v):
    return 1 / (1 + np.exp(-v))


def _np_forward(xp, mask, wh, rev):
    """One lane, exactly the kernel's bf16 semantics: h and Wh rounded to
    bf16 before each step's product, f32 arithmetic."""
    T, B, G = xp.shape
    H = G // 4
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    out = np.zeros((T, B, H), np.float32)
    act = np.zeros((T, B, G), np.float32)
    cs = np.zeros((T, B, H), np.float32)
    whr = _np_bf16(wh)
    for s in range(T):
        t = T - 1 - s if rev else s
        g = xp[t] + _np_bf16(h) @ whr
        i, f, gg, o = (_sig(g[:, :H]), _sig(g[:, H:2 * H]),
                       np.tanh(g[:, 2 * H:3 * H]), _sig(g[:, 3 * H:]))
        cn = f * c + i * gg
        hn = o * np.tanh(cn)
        m = mask[t][:, None]
        h = np.where(m > 0, hn, h).astype(np.float32)
        c = np.where(m > 0, cn, c).astype(np.float32)
        out[t] = hn * m
        act[t] = np.concatenate([i, f, gg, o], -1)
        cs[t] = c
    return out, act, cs


def _np_backward(dout, act, cs, mask, wh, rev):
    """The backward of ``_np_forward`` for d x_proj, dgates and Wh rounded
    to bf16 before each dgates @ Wh^T."""
    T, B, H = dout.shape
    order = [T - 1 - s if rev else s for s in range(T)]
    whr = _np_bf16(wh).T
    dxp = np.zeros((T, B, 4 * H), np.float32)
    dh_pass = np.zeros((B, H), np.float32)
    dc_pass = np.zeros((B, H), np.float32)
    rec = np.zeros((B, H), np.float32)
    for s in range(T - 1, -1, -1):
        t = order[s]
        c_prev = cs[order[s - 1]] if s > 0 else np.zeros((B, H), np.float32)
        i, f, g, o = np.split(act[t], 4, axis=-1)
        tc = np.tanh(cs[t])
        m = mask[t][:, None]
        dh = dh_pass + rec
        dhn = dh + dout[t] * m
        dcn = dc_pass + dhn * o * (1 - tc * tc)
        dg = np.concatenate([dcn * g * i * (1 - i), dcn * c_prev * f * (1 - f),
                             dcn * i * (1 - g * g), dhn * tc * o * (1 - o)],
                            -1)
        dg = np.where(m > 0, dg, 0).astype(np.float32)
        dh_pass = np.where(m > 0, 0, dh).astype(np.float32)
        dc_pass = np.where(m > 0, dcn * f, dc_pass).astype(np.float32)
        rec = _np_bf16(dg) @ whr
        dxp[t] = dg
    return dxp


def _lanes(rng, L=2, T=19, B=3, H=6):
    xp = (rng.standard_normal((L, T, B, 4 * H)) * 0.7).astype(np.float32)
    wh = (rng.standard_normal((L, H, 4 * H)) * 0.4).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.asarray([19, 11, 4])[None]).astype(
        np.float32)
    return xp, mask, wh, [False, True][:L]


def test_bf16_twin_forward_and_backward_match_numpy(rng):
    """Tight: the twin's outputs, saved states and d x_proj against the
    numpy reference of the same bf16 semantics, lane by lane; and the f32
    twin is farther off that reference than the tolerance."""
    xp, mask, wh, rev = _lanes(rng)
    t = [torch.from_numpy(a) for a in (xp, mask, wh)]
    out, act, cs, _ = lk.lstm_recurrence_reference(*t, rev, save=True,
                                                   bf16=True)
    dout = (rng.standard_normal(out.shape)).astype(np.float32)
    dxp = lk.lstm_recurrence_backward_reference(
        torch.from_numpy(dout), act, cs, t[1], t[2], rev, bf16=True)
    for l in range(len(rev)):
        w_out, w_act, w_cs = _np_forward(xp[l], mask, wh[l], rev[l])
        for got, want in ((out[l], w_out), (act[l], w_act), (cs[l], w_cs)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
        w_dxp = _np_backward(dout[l], act[l].numpy(), cs[l].numpy(), mask,
                             wh[l], rev[l])
        np.testing.assert_allclose(dxp[l].numpy(), w_dxp, rtol=1e-5,
                                   atol=1e-6)
    f32 = lk.lstm_recurrence_reference(*t, rev)
    assert (f32 - out).abs().max() > 1e-4


def test_bf16_weight_gradient_rounds_its_operands(rng):
    """dWh = sum h_prev^T dgates over bf16-rounded operands with f32 sums,
    through the autograd function, against numpy on the rounded values."""
    xp, mask, wh, rev = _lanes(rng, L=1)
    xt = torch.from_numpy(xp).requires_grad_()
    wt = torch.from_numpy(wh).requires_grad_()
    out = lk.lstm_recurrence(xt, torch.from_numpy(mask), wt, rev, bf16=True)
    dout = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(dout))
    _, _, hs, = lk.lstm_recurrence_reference(
        torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh),
        rev, save=True, bf16=True)[1:]
    h_prev = lk._h_before(hs, rev)[0].numpy().reshape(-1, wh.shape[1])
    dg = xt.grad[0].numpy().reshape(-1, wh.shape[2])
    want = _np_bf16(h_prev).astype(np.float64).T @ _np_bf16(dg)
    np.testing.assert_allclose(wt.grad[0].numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_bf16_recurrence_matches_jax_at_a_measured_tolerance(rng, bf16):
    """The port's ganged BiLSTM in bf16 mode (projection and recurrence)
    against ``multi_bilstm_scan`` in bf16 mode, outputs and gradients
    (each leaf by Frobenius norm); a single lane against ``lstm_scan``
    and against the Pallas kernel in interpret mode at DEFAULT."""
    P, B, T, C, H = 2, 3, 13, 5, 6
    xs = rng.standard_normal((P, B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[13], [8], [2]])).astype(
        np.float32)
    wi = (rng.standard_normal((P, C, 8 * H)) * 0.4).astype(np.float32)
    wh = (rng.standard_normal((P, 2, H, 4 * H)) * 0.4).astype(np.float32)
    bias = (rng.standard_normal((P, 2, 4 * H)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((P, B, T, 2 * H)).astype(np.float32)
    args = (xs, mask, wi, wh, bias)

    def jax_loss(xs, wi, wh, bias):
        y = jax_multi_bilstm_scan(xs, jnp.asarray(mask), wi, wh, bias)
        return (y * dy).sum(), y

    (_, want), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *[jnp.asarray(a) for a in (xs, wi, wh, bias)])
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    got = multi_bilstm_scan(*t)
    (got * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=BF16_LSTM_ATOL)
    for name, g, w in zip(("xs", "wi", "wh", "bias"),
                          (t[0].grad, t[2].grad, t[3].grad, t[4].grad), jg):
        w = np.asarray(w)
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= BF16_LSTM_GRAD_RTOL, (name, err)

    x1 = rng.standard_normal((B, T, C)).astype(np.float32)
    wi1 = (rng.standard_normal((C, 4 * H)) * 0.4).astype(np.float32)
    wh1, b1 = wh[0, 0], bias[0, 0]
    want1 = np.asarray(jax_lstm_scan(*[jnp.asarray(a) for a in (
        x1, mask, wi1, wh1, b1)]))
    xp1 = np.ascontiguousarray(np.einsum("btc,cg->tbg", x1, wi1) + b1)
    want_pallas = np.asarray(lstm_recurrence_pallas(
        jnp.asarray(xp1), jnp.asarray(mask.T.copy()), jnp.asarray(wh1),
        chunk=8, interpret=True, precision=jax.lax.Precision.DEFAULT))
    got1 = lk.lstm_recurrence(torch.from_numpy(xp1.astype(np.float32))[None],
                              torch.from_numpy(mask.T.copy()),
                              torch.from_numpy(wh1)[None], [False])[0].numpy()
    np.testing.assert_allclose(got1, want_pallas, atol=BF16_LSTM_ATOL)
    np.testing.assert_allclose(got1.transpose(1, 0, 2), want1,
                               atol=BF16_LSTM_ATOL)


# --- the bf16 plans --------------------------------------------------------

# (L, B, H, direction): the bf16 plan's (route, n_cta, hb, ks), its shared
# memory in bytes, its tiling (mma a warp issues a step for an N tile of 8
# rows, M tiles a warp takes at once, A fragments a warp keeps in shared
# memory: those past its registers' two), and the f32 plan's (route,
# n_cta, hb, ks), unchanged
BF16_PLANS = [
    # text encoder: 5 x 17 tiles over 3 x 4 warps
    ((2, 8, 260, "fwd"), ("cluster", 16, 17, 4), 68608, (10, 2, 8),
     ("cluster", 16, 17, 7)),
    ((2, 1, 260, "fwd"), ("cluster", 16, 17, 4), 68608, (10, 2, 8),
     ("cluster", 16, 17, 7)),
    # the duration DAP and the ganged frame DAPs: 2 x 8 tiles over 3 x 4
    # warps, both fragments of a warp in its registers
    ((2, 8, 128, "fwd"), ("cluster", 16, 8, 4), 8704, (2, 1, 0),
     ("cluster", 16, 8, 8)),
    ((6, 8, 128, "fwd"), ("cluster", 16, 8, 4), 8704, (2, 1, 0),
     ("cluster", 16, 8, 8)),
    ((6, 1, 128, "fwd"), ("cluster", 16, 8, 4), 8704, (2, 1, 0),
     ("cluster", 16, 8, 8)),
    # the flow context: 9 x 33 tiles over 3 x 4 warps, all 27 fragments of
    # a warp in shared memory (3 M tiles a warp leave no register for them)
    ((2, 1, 528, "fwd"), ("cluster", 16, 33, 4), 201728, (27, 3, 27),
     ("grid", 66, 8, 8)),
    ((2, 8, 528, "fwd"), ("cluster", 16, 33, 4), 201728, (27, 3, 27),
     ("grid", 66, 8, 8)),
    # backward: H / 16 M tiles over 12 warps, the CTA's 4 hb columns deep
    ((2, 8, 260, "bwd"), ("cluster", 16, 17, 1), 67840, (10, 2, 8),
     ("cluster", 16, 17, 2)),
    ((2, 8, 128, "bwd"), ("cluster", 16, 8, 1), 8704, (2, 1, 0),
     ("cluster", 16, 8, 2)),
    ((6, 8, 128, "bwd"), ("cluster", 16, 8, 1), 8704, (2, 1, 0),
     ("cluster", 16, 8, 2)),
    ((2, 8, 528, "bwd"), ("cluster", 16, 33, 1), 201984, (27, 3, 27),
     ("grid", 66, 8, 1)),
    # past the model's batches, two N tiles: the slices no longer fit a
    # cluster's shared memory at H 528
    ((2, 11, 528, "fwd"), ("grid", 66, 8, 4), 69120, (9, 1, 7),
     ("grid", 66, 8, 8)),
    ((2, 11, 528, "bwd"), ("grid", 66, 8, 1), 39424, (6, 3, 6),
     ("grid", 66, 8, 1))]


@pytest.mark.parametrize("shape,plan,smem,tiling,f32_plan", BF16_PLANS)
def test_bf16_plans_at_the_model_shapes(shape, plan, smem, tiling, f32_plan):
    """The bf16 kernels' plans (lstm_recurrence_bf16.cu) on an H100's
    limits: a cluster a lane at every model shape, the flow context's H 528
    too, whose Wh slices are A fragments read from shared memory a warp at
    a time (the f32 plan keeps its 66-CTA grid); the forward's warps split
    the H reduction 4 ways; the shared memory of fwd_layout and bwd_layout;
    the warps' tiling of the product and the A fragments past each thread's
    two registers of fragments. The f32 plans stay as they were."""
    L, B, H, direction = shape
    plan_fn, smem_fn = {
        "fwd": (lk.forward_plan, lk._fwd_smem_bf16),
        "bwd": (lk.backward_plan, lk._bwd_smem_bf16)}[direction]
    got = plan_fn(L, B, H, H100, bf16=True)
    assert (got.route, got.n_cta, got.hb, got.ks) == plan
    assert got.smem == smem == smem_fn(B, H, got.hb, got.ks, got.n_cta,
                                       got.route == "cluster")
    assert got.smem <= H100.smem_per_block
    assert B * got.hb <= lk._BF16_THREADS
    M, K = -(-4 * got.hb // 16), -(-H // 16)
    if direction == "bwd":
        M, K = K, M
    assert lk._bf16_tiling(M, K, got.ks) == tiling
    f32 = plan_fn(L, B, H, H100)
    assert (f32.route, f32.n_cta, f32.hb, f32.ks) == f32_plan
    # the other route, which the card's tests and chip_smoke.py time
    other = "grid" if got.route == "cluster" else None
    if other:
        grid = plan_fn(L, B, H, H100, bf16=True, route=other)
        assert grid.route == "grid" and grid.n_cta * grid.hb >= H


# --- one training step, the port against JAX ------------------------------

@pytest.fixture(scope="module")
def setup():
    jm = JaxTTSModel(config=_no_dropout_config())
    batch = tiny_batch(np.random.default_rng(0))
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    return jm, perturb(v), {k: np.asarray(a) for k, a in batch.items()}


def _port(jm, v) -> TTSModel:
    port = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    return port.train()


def _port_step(jm, v, batch):
    port = _port(jm, v)
    tb = {k: torch.from_numpy(a.copy()) for k, a in batch.items()}
    out = port(tb, binarize=True, train=True)
    ld = step.compute_losses(port, step.LossConfig(**REG), out, tb, True)
    step.total_loss(ld).backward()
    return port, {k: val.item() for k, (val, _) in ld.items()}


def test_training_step_in_bf16_matches_jax(setup, bf16):
    """binarize and kl on: every loss term, then the gradients by
    Frobenius norm: each leaf's difference over the leaf's norm (at least
    1e-6 of the tree's largest entry), their median, and the whole tree's;
    the f32 port misses JAX's bf16 loss terms by more than the bf16 port
    does."""
    jm, v, batch = setup
    jcfg = jax_step.LossConfig(**REG)

    def loss_fn(params):
        out, _ = jm.apply(
            {"params": params, "buffers": v["buffers"],
             "spectral": v["spectral"]}, batch, binarize=True, train=True,
            mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.key(2)})
        ld = jax_step.compute_losses(jm, jcfg, params, out, batch,
                                     binarization_on=True)
        return jax_step.total_loss(ld), ld

    (_, jld), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    port, ld = _port_step(jm, v, batch)
    assert set(ld) == set(jld)
    err = {k: abs(ld[k] - float(jld[k][0])) for k in ld}
    for k, e in err.items():
        assert e <= 1e-4 + BF16_LOSS_RTOL * abs(float(jld[k][0])), (k, e)
    want = tts_state_dict_from_jax({"params": g})
    tree = max(float(w.abs().max()) for w in want.values())
    errs, diff2, norm2 = {}, 0.0, 0.0
    for name, p in port.named_parameters():
        gp = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[name]
        errs[name] = float((gp - w).norm()) / max(float(w.norm()),
                                                  1e-6 * tree)
        diff2 += float((gp - w).norm()) ** 2
        norm2 += float(w.norm()) ** 2
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BF16_LEAF_RTOL, (worst, errs[worst])
    assert np.median(list(errs.values())) <= BF16_GRAD_RTOL
    assert (diff2 / norm2) ** 0.5 <= BF16_GRAD_RTOL

    pconv.set_conv_precision("f32")
    _, ld32 = _port_step(jm, v, batch)
    assert sum(abs(ld32[k] - float(jld[k][0])) for k in ld) > sum(
        err.values())


# --- the trainer, the CLI and serving --------------------------------------

def test_cli_fit_trains_in_bf16_on_the_cpu(cfg_files, tmp_path, monkeypatch):
    """``fit`` with ``model.conv_precision: bf16``: two steps and a
    validation, every logged value finite, every recurrence in bf16, the
    switch set for the process until a trainer in f32 puts it back."""
    path, _, _ = cfg_files
    modes = []
    twin = lk.lstm_recurrence_reference

    def spy(*a, bf16=False, **kw):
        modes.append(bf16)
        return twin(*a, bf16=bf16, **kw)

    monkeypatch.setattr(lk, "lstm_recurrence_reference", spy)
    out = tmp_path / "run"
    try:
        _, tr = torch_cli.main([
            "fit", "-c", path, "--device", "cpu",
            "--model.conv_precision=bf16", f"--model.output_directory={out}",
            "--trainer.max_steps=2", "--trainer.val_check_interval=2",
            "--trainer.megastep_k=1", "--model.iters_per_checkpoint=100"])
        assert pconv.get_conv_precision() == "bf16"
    finally:
        pconv.set_conv_precision("f32")
    assert tr.stats["steps"] == 2 and modes and all(modes)
    import json
    rows = [json.loads(r) for r in open(out / "tb" / "metrics.jsonl")]
    assert any("val/loss" in r for r in rows)
    for r in rows:
        assert all(np.isfinite(x) for k, x in r.items() if k != "step"), r


def test_served_precision_is_the_loading_processes(setup, rng, tmp_path):
    """The artifact records no precision: an artifact exported in bf16
    mode and one exported in f32 serve alike, in f32 under f32 and in bf16
    under bf16 (``RADMMM_CONV_PRECISION=bf16`` for ``python -m
    radmmm_torch``), unlike the JAX package's exported programs, which
    keep the precision they were traced at (ROADMAP Queue 3)."""
    jm, v, _ = setup
    port = _port(jm, v).eval()
    paths = {}
    for mode in ("f32", "bf16"):
        pconv.set_conv_precision(mode)
        try:
            paths[mode] = str(tmp_path / f"tts_{mode}.pt")
            export_tts(port, paths[mode], sigma=0.0, max_frames=24,
                       buckets=[(1, 8)])
        finally:
            pconv.set_conv_precision("f32")
    req = (rng.integers(1, 30, (1, 6)).astype(np.int32),
           np.asarray([6], np.int32), np.asarray([1], np.int32),
           np.asarray([0], np.int32), np.asarray([5.0], np.float32),
           np.asarray([0.3], np.float32), 0)
    mels = {}
    for serve_mode in ("f32", "bf16"):
        pconv.set_conv_precision(serve_mode)
        try:
            for mode, p in paths.items():
                mels[mode, serve_mode] = load_tts(p, device="cpu")(
                    *req)[0].numpy()
        finally:
            pconv.set_conv_precision("f32")
    for serve_mode in ("f32", "bf16"):
        np.testing.assert_array_equal(mels["f32", serve_mode],
                                      mels["bf16", serve_mode])
    assert np.abs(mels["f32", "f32"] - mels["f32", "bf16"]).max() > 0


def test_environment_sets_the_switch_at_import():
    """RADMMM_CONV_PRECISION=bf16 and RADMMM_BF16_CAST=0, read when
    ``radmmm_torch.ops.conv`` is imported, as the JAX module reads them:
    one fresh interpreter imports (and reimports) it under each setting."""
    code = (
        "import importlib, os\n"
        "import radmmm_torch.ops.conv as c\n"
        "print(c.get_conv_precision(), c._BF16_CAST)\n"
        "os.environ['RADMMM_CONV_PRECISION'] = 'bf16'\n"
        "print(*(lambda m: (m.get_conv_precision(), m._BF16_CAST))("
        "importlib.reload(c)))\n"
        "os.environ['RADMMM_BF16_CAST'] = '0'\n"
        "print(*(lambda m: (m.get_conv_precision(), m._BF16_CAST))("
        "importlib.reload(c)))\n")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("RADMMM_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=base,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.splitlines() == ["f32 True", "bf16 True",
                                       "bf16 False"], out.stderr
