"""radmmm_torch's spline transforms and MaskedBatchNorm against their JAX
twins on the same inputs from a numpy seed.

Tolerance: 1e-5 relative with a 1e-6 floor for values near 0 (f32 on both
sides; softmax, cumsum and log round in another order). The quadratic
inverse is held to JAX's where its bins' slopes vary (random logits);
where they barely do, JAX's root formula cancels and the port's inverse is
held to the input it inverts instead. Points exactly on
a bin edge, at 0 and at 1 must land in the bin JAX picks: the transforms
are continuous there, so a bin picked one off would still agree in value,
and the tests also compare the bin's slope through the log-determinant,
which jumps at an edge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.ops import splines as J
from radmmm_tpu.ops.norms import MaskedBatchNorm as JaxMaskedBatchNorm
from radmmm_torch.ops import splines as S
from radmmm_torch.ops.norms import MaskedBatchNorm
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _linear_inputs(rng, N=24, K=5, n_bins=8):
    """Random points and bin logits; rows 0-1 put points on bin edges, 0
    and 1 (k / 8 is exact in f32), and rows 0-3 have equal logits, so that
    their CDF knots, the inverse's edges, are k / 8 exactly in both
    packages (softmax and cumsum of random logits may differ in the last
    bit, which moves a knot off a point put on it)."""
    x = rng.uniform(-0.3, 1.3, (N, K)).astype(np.float32)
    x[0] = [0.0, 1.0, 0.125, 0.5, 0.875]
    x[1] = [0.25, 0.375, 0.625, 0.75, 1.0 - 2 ** -24]
    x[2] = [0.0, 1.0, 0.125, 0.5, 0.875]
    x[3] = [0.25, 0.375, 0.625, 0.75, 1.0]
    q = rng.standard_normal((N, K, n_bins)).astype(np.float32)
    q[:4] = 0.0
    return x, q


@pytest.mark.parametrize("passthru", [True, False])
def test_piecewise_linear_forward(rng, passthru):
    x, q = _linear_inputs(rng)
    y, logj = S.piecewise_linear_transform(_t(x), _t(q), passthru)
    wy, wlogj = J.piecewise_linear_transform(jnp.asarray(x), jnp.asarray(q),
                                             passthru)
    _close(y, wy)
    _close(logj, wlogj)


@pytest.mark.parametrize("passthru", [True, False])
def test_piecewise_linear_inverse(rng, passthru):
    x, q = _linear_inputs(rng)
    q[4:8] = 0.0
    q[4:8, :, 2] = np.log(3.0)   # slopes 3/10 and 1/10: knots off k / 8
    y, logj = S.piecewise_linear_inverse_transform(_t(x), _t(q), passthru)
    wy, wlogj = J.piecewise_linear_inverse_transform(
        jnp.asarray(x), jnp.asarray(q), passthru)
    _close(y, wy)
    _close(logj, wlogj)


def test_piecewise_linear_round_trip(rng):
    x, q = _linear_inputs(rng)
    x = np.clip(x, 0.01, 0.99)
    y, logj = S.piecewise_linear_transform(_t(x), _t(q))
    x2, logj_inv = S.piecewise_linear_inverse_transform(y, _t(q))
    np.testing.assert_allclose(x2.numpy(), x, atol=2e-5)
    np.testing.assert_allclose(logj.numpy(), -logj_inv.numpy(), atol=2e-5)


def test_weighted_softmax(rng):
    v = rng.standard_normal((6, 4, 9)).astype(np.float32)
    w = rng.uniform(0.05, 0.3, (6, 4, 8)).astype(np.float32)
    _close(S._weighted_softmax(_t(v), _t(w)),
           J._weighted_softmax(jnp.asarray(v), jnp.asarray(w)))


def _quad_inputs(rng, N=16, C=5, K=8):
    """Random points and logits; row 0 has equal logits, so its bin edges
    and CDF knots are k / 8 exactly in both packages, and its points sit
    on them, at 0 and at 1."""
    w_t = rng.standard_normal((N, C, K)).astype(np.float32)
    v_t = rng.standard_normal((N, C, K + 1)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (N, C)).astype(np.float32)
    w_t[0], v_t[0] = 0.0, 0.0
    x[0] = [0.0, 0.125, 0.5, 0.875, 1.0]
    return x, w_t, v_t


@pytest.mark.parametrize("inverse", [False, True])
def test_piecewise_quadratic(rng, inverse):
    x, w_t, v_t = _quad_inputs(rng)
    got, glog = S.piecewise_quadratic_transform(_t(x), _t(w_t), _t(v_t),
                                                inverse=inverse)
    want, wlog = J.piecewise_quadratic_transform(
        jnp.asarray(x), jnp.asarray(w_t), jnp.asarray(v_t), inverse=inverse)
    _close(got, want)
    if inverse:
        assert glog is None and wlog is None
    else:
        _close(glog, wlog)


def test_quadratic_inverse_where_the_slope_is_flat(rng):
    """Near-equal logits (a spline coupling at init, its last conv zero):
    the quadratic coefficient a is near 0 and JAX's root formula cancels.
    The port's conjugate form inverts JAX's forward to 2e-6 of the input
    (the f32 rounding of the forward, times a slope near 1); JAX's own
    inverse is off by more, and the two differ by no more than its error."""
    N, C, K = 64, 4, 8
    w_t = (rng.standard_normal((N, C, K)) * 1e-2).astype(np.float32)
    v_t = (rng.standard_normal((N, C, K + 1)) * 1e-2).astype(np.float32)
    x = rng.uniform(0.01, 0.99, (N, C)).astype(np.float32)
    y, _ = J.piecewise_quadratic_transform(*_jnp(x, w_t, v_t))
    got, _ = S.piecewise_quadratic_transform(_t(y), _t(w_t), _t(v_t),
                                             inverse=True)
    want, _ = J.piecewise_quadratic_transform(y, *_jnp(w_t, v_t),
                                              inverse=True)
    port_err = float(np.abs(got.numpy() - x).max())
    jax_err = float(np.abs(np.asarray(want) - x).max())
    assert port_err <= 2e-6 < jax_err, (port_err, jax_err)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=jax_err + port_err)


def test_piecewise_quadratic_round_trip(rng):
    x, w_t, v_t = _quad_inputs(rng)
    x = np.clip(x, 0.02, 0.98)
    y, _ = S.piecewise_quadratic_transform(_t(x), _t(w_t), _t(v_t))
    x2, _ = S.piecewise_quadratic_transform(y, _t(w_t), _t(v_t),
                                            inverse=True)
    np.testing.assert_allclose(x2.numpy(), x, atol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_unbounded_quadratic_is_identity_outside(rng, inverse):
    x, w_t, v_t = _quad_inputs(rng)
    x[3] = [-0.5, 1.0, 1.7, -1e-7, 2.0]
    x[4] = rng.uniform(-2, 3, 5)
    got, glog = S.unbounded_piecewise_quadratic_transform(
        _t(x), _t(w_t), _t(v_t), inverse=inverse)
    want, wlog = J.unbounded_piecewise_quadratic_transform(
        jnp.asarray(x), jnp.asarray(w_t), jnp.asarray(v_t), inverse=inverse)
    _close(got, want)
    outside = (x < 0) | (x >= 1)
    np.testing.assert_array_equal(got.numpy()[outside], x[outside])
    if not inverse:
        _close(glog, wlog)
        assert (glog.numpy()[outside] == 0).all()


def test_quadratic_gradients_match_jax(rng):
    """The log-determinant's gradient in the bin logits (what the flow
    loss differentiates)."""
    x, w_t, v_t = _quad_inputs(rng)

    def jloss(w, v):
        y, lj = J.piecewise_quadratic_transform(jnp.asarray(x), w, v)
        return jnp.sum(y * y) + jnp.sum(lj)

    gw, gv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w_t),
                                            jnp.asarray(v_t))
    tw, tv = _t(w_t).requires_grad_(), _t(v_t).requires_grad_()
    y, lj = S.piecewise_quadratic_transform(_t(x), tw, tv)
    ((y * y).sum() + lj.sum()).backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv), rtol=1e-4,
                               atol=1e-5)


# -- MaskedBatchNorm --------------------------------------------------------

def _bn_inputs(rng, B=3, T=11, C=6):
    x = (rng.standard_normal((B, T, C)) * 2 + 0.5).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[11], [7], [2]])
    return x, mask


def _jax_bn(rng_seed=0):
    bn = JaxMaskedBatchNorm(6)
    x, mask = _bn_inputs(np.random.default_rng(rng_seed))
    variables = bn.init(jax.random.key(0), jnp.asarray(x),
                        jnp.asarray(mask))
    p = np.random.default_rng(5)
    variables = {"params": {"scale": 1 + 0.1 * p.standard_normal(6).astype(
        np.float32), "bias": 0.1 * p.standard_normal(6).astype(np.float32)},
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"])}
    return bn, variables


def _port_bn(variables):
    bn = MaskedBatchNorm(6)
    bn.load_state_dict({"scale": _t(variables["params"]["scale"]),
                        "bias": _t(variables["params"]["bias"]),
                        "mean": _t(variables["batch_stats"]["mean"]),
                        "var": _t(variables["batch_stats"]["var"])})
    return bn


def test_masked_batch_norm_train_and_running_stats(rng):
    """Two training updates (masked batch statistics, running stats moved
    with momentum 0.1 and the unbiased variance), then eval on the
    running statistics."""
    jbn, variables = _jax_bn()
    port = _port_bn(variables)
    for _ in range(2):
        x, mask = _bn_inputs(rng)
        want, mut = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                              train=True, mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mut["batch_stats"]}
        _close(port(_t(x), _t(mask), train=True).detach(), want)
        _close(port.mean, variables["batch_stats"]["mean"])
        _close(port.var, variables["batch_stats"]["var"])
    x, mask = _bn_inputs(rng)
    want = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                     train=False)
    before = port.mean.clone()
    _close(port(_t(x), _t(mask), train=False).detach(), want)
    assert torch.equal(port.mean, before)      # eval moves nothing


def test_masked_batch_norm_gradients_match_jax(rng):
    jbn, variables = _jax_bn()
    x, mask = _bn_inputs(rng)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(params, xx):
        out, _ = jbn.apply({**variables, "params": params}, xx,
                           jnp.asarray(mask), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(out * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    port = _port_bn(variables)
    tx = _t(x).requires_grad_()
    (port(tx, _t(mask), train=True) * _t(w)).sum().backward()
    for got, want in ((tx.grad, gx), (port.scale.grad, gp["scale"]),
                      (port.bias.grad, gp["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_sync_batch_norm_names_m13(rng):
    """sync=True (M13's sync-BN) in one process: the batch is the global
    batch, so it normalises and moves the running statistics exactly as
    sync=False does."""
    x, mask = _bn_inputs(rng)
    outs, stats = [], []
    for sync in (False, True):
        bn = MaskedBatchNorm(6)
        outs.append(bn(_t(x), _t(mask), sync=sync))
        stats.append((bn.mean.clone(), bn.var.clone()))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*stats))
