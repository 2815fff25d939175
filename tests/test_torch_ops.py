"""radmmm_torch ops against their JAX twins on copied weights.

Tolerance 1e-5 (f32 on both sides; JAX at matmul precision 'highest', so
only the order of sums differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.ops.attention import ConvAttention as JaxConvAttention
from radmmm_tpu.ops.conv import MaskedConv1d as JaxMaskedConv1d
from radmmm_tpu.ops.coupling import AffineCoupling as JaxAffineCoupling
from radmmm_tpu.ops.coupling import scaling_and_logs as jax_scaling_and_logs
from radmmm_tpu.ops.invertible import InvertibleLU as JaxInvertibleLU
from radmmm_tpu.ops.invertible import WhiteningConv as JaxWhiteningConv
from radmmm_tpu.ops.length_regulator import (
    regulate_length as jax_regulate_length)
from radmmm_tpu.ops.norms import MaskedInstanceNorm1d as JaxInstanceNorm
from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.ops.attention import ConvAttention
from radmmm_torch.ops.conv import Linear, MaskedConv1d
from radmmm_torch.ops.coupling import AffineCoupling, scaling_and_logs
from radmmm_torch.ops.invertible import InvertibleLU, WhiteningConv
from radmmm_torch.ops.length_regulator import regulate_length
from radmmm_torch.ops.norms import MaskedInstanceNorm1d
from radmmm_torch.utils.masking import SeqLens
from tests.test_torch_convert import perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _port(module, variables):
    module.load_state_dict(tts_state_dict_from_jax(variables))
    return module.eval()


def _inputs(rng, B=3, T=13, C=6, lengths=(13, 8, 3)):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return x, mask


# (kernel, dilation, partial padding, weight norm, premask_input, mask)
CONV_CASES = [
    (5, 1, True, True, True, True),
    (5, 2, True, True, True, True),
    (5, 4, True, True, True, True),
    (5, 8, True, True, True, True),
    (3, 1, False, True, False, True),    # the DAP bottleneck
    (3, 2, False, False, True, True),    # plain kernel, premasked input
    (1, 1, False, True, True, False),    # WN start/res_skip: no mask
    (5, 1, True, True, True, False),     # partial padding without a mask
]


@pytest.mark.parametrize("k,dil,pp,wn,premask,use_mask", CONV_CASES)
def test_masked_conv1d(rng, k, dil, pp, wn, premask, use_mask):
    x, mask = _inputs(rng)
    m = jnp.asarray(mask) if use_mask else None
    mod = JaxMaskedConv1d(7, k, dilation=dil, use_partial_padding=pp,
                          use_weight_norm=wn, premask_input=premask)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(x), m))
    want = np.asarray(mod.apply(variables, jnp.asarray(x), m))
    port = _port(MaskedConv1d(6, 7, k, dilation=dil, use_partial_padding=pp,
                              use_weight_norm=wn, premask_input=premask),
                 variables)
    got = port(torch.from_numpy(x),
               torch.from_numpy(mask) if use_mask else None)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    if not premask and use_mask:
        # without pre-masking the last valid frame sees the padded one
        x2 = x.copy()
        x2[2, 3] += 10.0
        got2 = port(torch.from_numpy(x2), torch.from_numpy(mask))
        assert not np.allclose(got2.detach().numpy()[2, 2],
                               got.detach().numpy()[2, 2])


def test_linear(rng):
    from radmmm_tpu.ops.conv import Linear as JaxLinear
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    mod = JaxLinear(4)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    got = _port(Linear(6, 4), variables)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("use_mask", [True, False])
def test_masked_instance_norm(rng, use_mask):
    x, mask = _inputs(rng)
    x = x * 3.0 + 1.5
    m = jnp.asarray(mask) if use_mask else None
    mod = JaxInstanceNorm(6)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(x), m))
    want = np.asarray(mod.apply(variables, jnp.asarray(x), m))
    got = _port(MaskedInstanceNorm1d(6), variables)(
        torch.from_numpy(x), torch.from_numpy(mask) if use_mask else None)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("max_out", [12, 30])
def test_regulate_length(rng, max_out):
    """Zero durations, and (max_out=12) totals past the output length."""
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    dur = np.array([[2, 0, 3, 1, 0, 4], [0, 0, 5, 5, 5, 0],
                    [1, 1, 1, 0, 0, 0]], np.int32)
    want, want_lens = jax_regulate_length(jnp.asarray(x), jnp.asarray(dur),
                                          max_out)
    got, got_lens = regulate_length(torch.from_numpy(x),
                                    torch.from_numpy(dur), max_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_seq_lens_downsample():
    lens = np.array([9, 4, 0], np.int32)
    want = JaxSeqLens.create(jnp.asarray(lens), 10).downsample(2)
    got = SeqLens.create(torch.from_numpy(lens), 10).downsample(2)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


@pytest.mark.parametrize("kind", ["lu", "whiten"])
@pytest.mark.parametrize("cached", [False, True])
def test_invertible_inverse(rng, kind, cached):
    C = 10
    z = rng.standard_normal((2, 7, C)).astype(np.float32)
    jax_cls, port_cls = ((JaxInvertibleLU, InvertibleLU) if kind == "lu"
                         else (JaxWhiteningConv, WhiteningConv))
    mod = jax_cls(C, init_seed=3)
    variables = perturb(mod.init(jax.random.key(0), jnp.asarray(z)))
    want = np.asarray(mod.apply(variables, jnp.asarray(z), inverse=True))
    port = _port(port_cls(C, init_seed=3), variables)
    if cached:
        port.cache_inverse()
    got = port.inverse(torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_invertible_init_matches_jax_init():
    """A port module initialised from its seed holds the JAX module's LU
    factors (same host-side numpy/scipy factorisation)."""
    variables = JaxInvertibleLU(6, init_seed=5).init(
        jax.random.key(0), jnp.zeros((1, 2, 6)))
    port = InvertibleLU(6, init_seed=5)
    np.testing.assert_array_equal(port.p.numpy(),
                                  np.asarray(variables["buffers"]["p"]))
    for name in ("lower", "upper", "upper_diag"):
        np.testing.assert_array_equal(
            getattr(port, name).detach().numpy(),
            np.asarray(variables["params"][name]))


@pytest.mark.parametrize("fn", ["translate", "exp", "tanh", "sigmoid"])
def test_scaling_and_logs(rng, fn):
    u = rng.standard_normal((2, 5, 3)).astype(np.float32)
    ws, wl = jax_scaling_and_logs(jnp.asarray(u), fn)
    gs, gl = scaling_and_logs(torch.from_numpy(u), fn)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=ATOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)


def test_affine_coupling_inverse(rng):
    """WN-parameterised coupling with partial padding, tanh scaling."""
    B, T, C, Cc = 2, 10, 6, 5
    z = rng.standard_normal((B, T, C)).astype(np.float32)
    ctx = rng.standard_normal((B, T, Cc)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[10], [6]])
    mod = JaxAffineCoupling(C, n_layers=2, scaling_fn="tanh", n_channels=16,
                            use_partial_padding=True)
    args = (jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(mask))
    variables = perturb(mod.init(jax.random.key(0), *args))
    want = np.asarray(mod.apply(variables, *args, inverse=True))
    port = _port(AffineCoupling(C, Cc, 2, scaling_fn="tanh", n_channels=16,
                                use_partial_padding=True), variables)
    got = port.inverse(torch.from_numpy(z), torch.from_numpy(ctx),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    # and it is the inverse of the JAX forward direction
    fwd, _ = mod.apply(variables, *args)
    back = port.inverse(torch.from_numpy(np.array(fwd)),
                        torch.from_numpy(ctx), torch.from_numpy(mask))
    np.testing.assert_allclose(back.detach().numpy(), z, atol=1e-4)


def test_conv_attention(rng):
    B, Tm, Tt = 2, 9, 5
    q = rng.standard_normal((B, Tm, 4)).astype(np.float32)
    k = rng.standard_normal((B, Tt, 6)).astype(np.float32)
    key_mask = np.arange(Tt)[None, :] < np.array([[5], [3]])
    prior = rng.uniform(0.1, 1.0, (B, Tm, Tt)).astype(np.float32)
    mod = JaxConvAttention(4, 6)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(key_mask),
            jnp.asarray(prior))
    variables = perturb(mod.init(jax.random.key(0), *args))
    want_attn, want_lp = mod.apply(variables, *args)
    port = _port(ConvAttention(4, 6), variables)
    attn, lp = port(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(key_mask), torch.from_numpy(prior))
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               atol=ATOL)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp),
                               atol=1e-4)
