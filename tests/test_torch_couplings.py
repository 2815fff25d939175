"""radmmm_torch's coupling layers and the spline flow against their JAX
twins on copied, perturbed weights and the same inputs from a numpy seed:
SimpleConvNet, FiLMStack (with and without batch norm, train and eval),
AffineCoupling's simple_conv and film_stack branches, SplineCoupling and
SplineCouplingAR (quadratic and linear), each forward (z and log s) and
inverse, and RADMMMFlow with spline steps: its training forward with the
batch norms' running statistics after the step, and its sampling
direction on the running statistics.

Tolerance: 1e-5 relative with a 1e-5 floor for single modules (f32 on
both sides, JAX at matmul precision 'highest'; the conv sums run in
another order, and a 512-channel FiLM stack's outputs reach a few units);
1e-4 for the whole flow, its sums carried through every step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models.flow_decoder import RADMMMFlow as JaxRADMMMFlow
from radmmm_tpu.ops import coupling as J
from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.models.flow_decoder import RADMMMFlow
from radmmm_torch.ops import coupling as P
from radmmm_torch.utils.masking import SeqLens
from tests.test_torch_convert import perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
FLOW_TOL = 1e-4
B, T, C_MEL, C_CTX = 3, 12, 8, 6
LENGTHS = (12, 8, 5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=None):
    rtol, atol = (RTOL, ATOL) if tol is None else (tol, tol)
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def _inputs(seed=0, c=C_MEL):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, T, c)).astype(np.float32)
    ctx = rng.standard_normal((B, T, C_CTX)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return z, ctx, mask


def _pair(jax_module, port_module, *init_args, **init_kw):
    """(flax variables perturbed, port module loaded with them)."""
    variables = jax.jit(functools.partial(jax_module.init, **init_kw))(
        jax.random.key(0), *init_args)
    variables = perturb(variables, seed=1)
    port_module.load_state_dict(tts_state_dict_from_jax(variables))
    return variables, port_module


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dilation,pp", [(True, True), (False, False)])
def test_simple_conv_net(dilation, pp):
    z, ctx, mask = _inputs()
    x = np.concatenate([z, ctx], -1)
    jm = J.SimpleConvNet(10, n_layers=3, kernel_size=3,
                         with_dilation=dilation, zero_init=True,
                         use_partial_padding=pp)
    v, port = _pair(jm, P.SimpleConvNet(C_MEL + C_CTX, 10, 3, 3, dilation,
                                        zero_init=True,
                                        use_partial_padding=pp),
                    *_jnp(x, mask))
    _close(port(_t(x), _t(mask)), jm.apply(v, *_jnp(x, mask)))


@pytest.mark.parametrize("use_bn,train", [(True, True), (True, False),
                                          (False, True)])
def test_film_stack(use_bn, train):
    z, ctx, mask = _inputs()
    jm = J.FiLMStack(16, 7, n_layers=3, kernel_size=3, use_bn=use_bn)
    v, port = _pair(jm, P.FiLMStack(C_MEL, C_CTX, 16, 7, 3, 3,
                                    use_bn=use_bn),
                    *_jnp(z, ctx, mask), train=False)
    want, mut = jm.apply(v, *_jnp(z, ctx, mask), train=train,
                         mutable=["batch_stats"])
    _close(port(_t(z), _t(ctx), _t(mask), train=train), want)
    if use_bn:
        got = tts_state_dict_from_jax({"batch_stats": mut["batch_stats"]})
        sd = port.state_dict()
        for k, w in got.items():
            _close(sd[k], w.numpy())


@pytest.mark.parametrize("affine_model", ["simple_conv", "film_stack"])
def test_affine_coupling_branches(affine_model):
    z, ctx, mask = _inputs()
    kw = dict(affine_model=affine_model, scaling_fn="tanh", kernel_size=3,
              use_partial_padding=True)
    jm = J.AffineCoupling(C_MEL, 2, **kw)
    v, port = _pair(jm, P.AffineCoupling(C_MEL, C_CTX, 2, **kw),
                    *_jnp(z, ctx, mask))
    want_z, want_ls = jm.apply(v, *_jnp(z, ctx, mask))
    got_z, got_ls = port(_t(z), _t(ctx), _t(mask))
    _close(got_z, want_z)
    _close(got_ls, want_ls)
    want_inv = jm.apply(v, want_z, *_jnp(ctx, mask), inverse=True)
    got_inv = port.inverse(got_z, _t(ctx), _t(mask))
    _close(got_inv, want_inv)
    _close(got_inv, z, tol=1e-4)                  # a round trip


def _quadratic_inverse_close(got, want, round_trip_port, round_trip_jax,
                             z):
    """A quadratic spline's inverse. JAX's root formula cancels where a
    bin's slope barely changes, as at these near-zero FiLM outputs, so the
    port's inverse is held to the input it inverts (its round trip, 1e-5)
    and to JAX's inverse within JAX's own round-trip error."""
    _close(round_trip_port, z)
    jax_err = float(np.abs(np.asarray(round_trip_jax) - z).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=jax_err + ATOL)


@pytest.mark.parametrize("quadratic", [True, False])
def test_spline_coupling(quadratic):
    z, ctx, mask = _inputs()
    z = z * 0.8
    kw = dict(n_bins=4, left=-3, right=3, bottom=-3, top=3,
              use_quadratic=quadratic, kernel_size=3)
    jm = J.SplineCoupling(C_MEL, 2, **kw)
    v, port = _pair(jm, P.SplineCoupling(C_MEL, C_CTX, 2, **kw),
                    *_jnp(z, ctx, mask), train=False)
    (want_z, want_ls), mut = jm.apply(v, *_jnp(z, ctx, mask), train=True,
                                      mutable=["batch_stats"])
    got_z, got_ls = port(_t(z), _t(ctx), _t(mask), train=True)
    _close(got_z, want_z)
    _close(got_ls, want_ls)
    sd = port.state_dict()
    for k, w in tts_state_dict_from_jax(
            {"batch_stats": mut["batch_stats"]}).items():
        _close(sd[k], w.numpy())
    # the inverse on the updated running statistics
    v = {**v, "batch_stats": mut["batch_stats"]}
    want_inv = jm.apply(v, want_z, *_jnp(ctx, mask), inverse=True,
                        train=False)
    got_inv = port.inverse(got_z, _t(ctx), _t(mask), train=False)
    if not quadratic:
        _close(got_inv, want_inv)
        return
    # round trips on the running statistics
    z_eval, _ = port(_t(z), _t(ctx), _t(mask), train=False)
    jz_eval, _ = jm.apply(v, *_jnp(z, ctx, mask), train=False)
    _quadratic_inverse_close(
        got_inv, want_inv,
        port.inverse(z_eval, _t(ctx), _t(mask), train=False),
        jm.apply(v, jz_eval, *_jnp(ctx, mask), inverse=True, train=False), z)


@pytest.mark.parametrize("quadratic", [True, False])
def test_spline_coupling_ar(quadratic):
    z, ctx, _ = _inputs()
    kw = dict(n_bins=4, use_quadratic=quadratic)
    jm = J.SplineCouplingAR(C_MEL, 2, **kw)
    v, port = _pair(jm, P.SplineCouplingAR(C_MEL, C_CTX, 2, **kw),
                    *_jnp(z, ctx))
    want_z, want_ls = jm.apply(v, *_jnp(z, ctx))
    got_z, got_ls = port(_t(z), _t(ctx))
    assert got_ls.shape == want_ls.shape
    _close(got_z, want_z)
    _close(got_ls, want_ls)
    got_inv = port.inverse(got_z, _t(ctx))
    want_inv = jm.apply(v, want_z, jnp.asarray(ctx), inverse=True)
    if quadratic:
        _quadratic_inverse_close(got_inv, want_inv, got_inv, want_inv, z)
    else:
        _close(got_inv, want_inv)


FLOW = dict(n_speaker_dim=4, use_accent=False, n_text_dim=6,
            n_mel_channels=C_MEL, n_flows=4, n_conv_layers_per_step=2,
            n_early_size=2, n_early_every=2, n_group_size=2,
            use_context_lstm=True, n_f0_dims=1, n_energy_avg_dims=1,
            n_splines=2, use_bn=True)


@functools.lru_cache(maxsize=None)
def _flows():
    z, ctx, mask = _inputs()
    rng = np.random.default_rng(3)
    spk = rng.standard_normal((B, 4)).astype(np.float32)
    f0 = rng.uniform(4, 6, (B, T)).astype(np.float32)
    en = rng.uniform(0, 1, (B, T)).astype(np.float32)
    jm = JaxRADMMMFlow(**FLOW)
    lens = JaxSeqLens.create(jnp.asarray(LENGTHS), T)
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), *_jnp(z, spk, ctx), lens, *_jnp(f0, en))
    variables = perturb(variables, seed=2)
    port = RADMMMFlow(**FLOW)
    port.load_state_dict(_flow_sd(variables))
    assert isinstance(port.flows[1].coupling, P.SplineCoupling)
    assert isinstance(port.flows[2].coupling, P.AffineCoupling)
    return jm, variables, port, (z, spk, ctx, f0, en)


def test_spline_flow_training_forward_and_running_stats():
    jm, v, port, (z, spk, ctx, f0, en) = _flows()
    lens = JaxSeqLens.create(jnp.asarray(LENGTHS), T)
    want, mut = jm.apply(v, *_jnp(z, spk, ctx), lens, *_jnp(f0, en),
                         train=True, mutable=["batch_stats", "spectral"])
    port = _copy(port)
    got = port(_t(z), _t(spk), _t(ctx), SeqLens.create(_t(LENGTHS), T),
               f0=_t(f0), energy_avg=_t(en), train=True)
    _close(got["z_mel"], want["z_mel"], FLOW_TOL)
    for g, w in zip(got["log_s_list"], want["log_s_list"]):
        _close(g, w, FLOW_TOL)
    for g, w in zip(got["log_det_W_list"], want["log_det_W_list"]):
        _close(g, w, FLOW_TOL)
    stats = _flow_sd({"batch_stats": mut["batch_stats"]})
    assert len(stats) == 2 * 2 * 2        # 2 spline steps x 2 blocks
    sd = port.state_dict()
    for k, w in stats.items():
        _close(sd[k], w.numpy(), FLOW_TOL)


def test_spline_flow_infer_inverts_forward_on_running_stats():
    """The sampling direction on the running statistics inverts the
    forward (train=False) on the valid frames: the port's to FLOW_TOL,
    JAX's to its own round-trip error (its quadratic inverse cancels at
    these near-zero FiLM outputs), and the two agree within that."""
    from radmmm_torch.ops.length_regulator import regulate_length
    jm, v, port, (_, spk, _, f0, en) = _flows()
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((B, T, C_MEL)).astype(np.float32)
    txt = rng.standard_normal((B, 5, 6)).astype(np.float32)
    dur = np.array([[3, 2, 4, 2, 1], [2, 2, 0, 3, 1], [1, 1, 1, 1, 1]],
                   np.int32)
    out_lens = np.minimum(dur.sum(1), T).astype(np.int32)
    ctx = regulate_length(_t(txt), _t(dur), T)[0].numpy()
    lens, jlens = (SeqLens.create(_t(out_lens), T),
                   JaxSeqLens.create(jnp.asarray(out_lens), T))
    z = port(_t(mel), _t(spk), _t(ctx), lens, f0=_t(f0), energy_avg=_t(en),
             train=False)["z_mel"].detach()
    jz = jm.apply(v, *_jnp(mel, spk, ctx), jlens, *_jnp(f0, en),
                  train=False)["z_mel"]
    _close(z, jz, FLOW_TOL)
    got = port.infer(_t(spk), _t(txt), 1.0, dur=_t(dur), f0=_t(f0),
                     energy_avg=_t(en), lens=lens, residual=z)["mel"]
    want = jm.apply(v, None, *_jnp(spk, txt), 1.0, jnp.asarray(dur),
                    *_jnp(f0, en), jlens, residual=jz,
                    method=JaxRADMMMFlow.infer)["mel"]
    valid = mel * lens.fmask().numpy()[..., None]
    _close(got, valid, FLOW_TOL)
    jax_err = float(np.abs(np.asarray(want) - valid).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=jax_err + FLOW_TOL)


def _flow_sd(variables):
    """The flow's state dict: its leaves as the bridge maps them under a
    TTS model's ``decoder``."""
    sd = tts_state_dict_from_jax({c: {"decoder": t}
                                  for c, t in variables.items()})
    return {k[len("decoder."):]: t for k, t in sd.items()}


def _copy(module):
    import copy
    return copy.deepcopy(module)
