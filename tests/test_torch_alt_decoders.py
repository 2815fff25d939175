"""radmmm_torch's alternative decoders, their losses and the
multi-resolution STFT loss against their JAX twins on copied, perturbed
weights and the same inputs from a numpy seed: StepEmbedding,
DiffusionWaveNet, DeterministicDecoder, E2ETTSDecoder (a small HiFi-GAN),
DiffusionDecoder's training forward and its ancestral sampling (JAX's
draws of t, the noise, the start latent and each step's z fed to the
port: the frameworks' random streams never match), the three losses of
``losses/flow.py`` and every function of ``losses/stft_loss.py``.

Tolerance: 1e-5 relative with a 1e-5 floor (f32 on both sides, JAX at
matmul precision 'highest'; sums and FFTs in another order). The sampled
mel after 10 steps, each dividing by sqrt(alpha) and adding its z, is
held to 1e-4; the HiFi-GAN waveform to 1e-5 of its peak, as
tests/test_torch_vocoder.py holds the generator."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.losses import flow as JL
from radmmm_tpu.losses import stft_loss as JS
from radmmm_tpu.models import alt_decoders as J
from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
from radmmm_tpu.vocoder.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from radmmm_torch.convert import alt_decoder_state_dict_from_jax
from radmmm_torch.losses import flow as PL
from radmmm_torch.losses import stft_loss as PS
from radmmm_torch.models import alt_decoders as P
from radmmm_torch.utils.masking import SeqLens
from radmmm_torch.vocoder.hifigan import HiFiGANConfig
from tests.test_torch_convert import SMALL_VOCODER, perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
B, T, C_CTX, N_MEL, N_SPK = 2, 16, 12, 8, 4
LENGTHS = (16, 10)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _inputs(seed=0, T=T):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((B, T, C_CTX)).astype(np.float32)
    spk = rng.standard_normal((B, N_SPK)).astype(np.float32)
    f0 = rng.uniform(0, 1, (B, T)).astype(np.float32)
    mel = rng.standard_normal((B, T, N_MEL)).astype(np.float32)
    lengths = (T, T - 6)
    return (ctx, spk, f0, mel, JaxSeqLens.create(jnp.asarray(lengths), T),
            SeqLens.create(_t(lengths), T))


def _init(module, *args, **kw):
    variables = jax.jit(functools.partial(module.init, **kw))(
        jax.random.key(0), *args)
    return perturb(variables, seed=4)


def _port(module, variables):
    module.load_state_dict(alt_decoder_state_dict_from_jax(variables))
    return module


def test_step_embedding():
    t = np.array([0, 1, 37, 99], np.int32)
    jm = J.StepEmbedding(16)
    v = _init(jm, jnp.asarray(t))
    port = _port(P.StepEmbedding(16), v)
    _close(port(_t(t)), jm.apply(v, jnp.asarray(t)))


def test_diffusion_wavenet():
    ctx, _, _, mel, jl, tl = _inputs()
    step = np.random.default_rng(1).standard_normal((B, 128)).astype(
        np.float32)
    jm = J.DiffusionWaveNet(N_MEL, C_CTX, n_layers=3, n_channels=16)
    args = [jnp.asarray(a) for a in (mel, ctx, step)]
    v = _init(jm, *args, jl.mask)
    port = _port(P.DiffusionWaveNet(N_MEL, C_CTX, 3, 16), v)
    _close(port(_t(mel), _t(ctx), _t(step), tl.mask),
           jm.apply(v, *args, jl.mask))


@pytest.mark.parametrize("with_f0", [True, False])
def test_deterministic_decoder(with_f0):
    ctx, spk, f0, _, jl, tl = _inputs()
    f0_j, f0_p = ((jnp.asarray(f0), _t(f0)) if with_f0 else (None, None))
    jm = J.DeterministicDecoder(n_mel_channels=N_MEL, n_speaker_dim=N_SPK,
                                n_layers=2, n_channels=16)
    v = _init(jm, jnp.asarray(ctx), jnp.asarray(spk), jl, f0_j, f0_j)
    n = 1 if with_f0 else 0
    port = _port(P.DeterministicDecoder(N_MEL, N_SPK, 2, 16,
                                        n_context_dim=C_CTX, n_f0_dims=n,
                                        n_energy_avg_dims=n), v)
    want = jm.apply(v, jnp.asarray(ctx), jnp.asarray(spk), jl, f0_j, f0_j)
    _close(port(_t(ctx), _t(spk), tl, f0_p, f0_p)["mel_hat"],
           want["mel_hat"])


def _e2e():
    ctx, spk, f0, _, jl, tl = _inputs(T=32)
    jm = J.E2ETTSDecoder(n_mel_channels=N_MEL, n_speaker_dim=N_SPK,
                         n_layers=1, n_channels=16,
                         vocoder_config=JaxHiFiGANConfig(**SMALL_VOCODER))
    args = [jnp.asarray(a) for a in (ctx, spk)]
    v = _init(jm, *args, jl, jnp.asarray(f0), jnp.asarray(f0))
    port = _port(P.E2ETTSDecoder(N_MEL, N_SPK, 1, 16,
                                 vocoder_config=HiFiGANConfig(
                                     **SMALL_VOCODER),
                                 n_context_dim=C_CTX), v)
    want = jm.apply(v, *args, jl, jnp.asarray(f0), jnp.asarray(f0),
                    train=False)
    got = port(_t(ctx), _t(spk), tl, _t(f0), _t(f0))
    return want, got


def test_e2e_tts_decoder():
    want, got = _e2e()
    _close(got["mel_hat"], want["mel_hat"])
    peak = float(np.abs(np.asarray(want["audio_hat"])).max())
    assert got["audio_hat"].shape == want["audio_hat"].shape == (B, 32 * 8)
    np.testing.assert_allclose(got["audio_hat"].detach().numpy(),
                               np.asarray(want["audio_hat"]), rtol=0,
                               atol=1e-5 * peak)


SCHEDULE = dict(n_steps=10)


@functools.lru_cache(maxsize=None)
def _diffusion():
    ctx, _, _, mel, jl, _ = _inputs()
    jm = J.DiffusionDecoder(n_mel_channels=N_MEL, n_context_dim=C_CTX,
                            n_layers=2, n_channels=16,
                            schedule=J.DiffusionSchedule(**SCHEDULE))
    v = _init(jm, jax.random.key(1), jnp.asarray(mel), jnp.asarray(ctx), jl)
    port = _port(P.DiffusionDecoder(N_MEL, C_CTX, 2, 16,
                                    P.DiffusionSchedule(**SCHEDULE)), v)
    return jm, v, port


def test_diffusion_schedule():
    np.testing.assert_array_equal(P.DiffusionSchedule().alpha_bars(),
                                  J.DiffusionSchedule().alpha_bars())


def test_diffusion_decoder_training_forward():
    jm, v, port = _diffusion()
    ctx, _, _, mel, jl, tl = _inputs()
    rng = jax.random.key(2)
    want = jm.apply(v, rng, jnp.asarray(mel), jnp.asarray(ctx), jl)
    # the draws JAX made inside, fed to the port
    rng_t, rng_n = jax.random.split(rng)
    t = jax.random.randint(rng_t, (B,), 0, SCHEDULE["n_steps"])
    noise = jax.random.normal(rng_n, mel.shape)
    got = port(_t(mel), _t(ctx), tl, t=_t(t), noise=_t(noise))
    _close(got["noise"], want["noise"])
    _close(got["noise_hat"], want["noise_hat"])


def test_diffusion_decoder_sampling():
    jm, v, port = _diffusion()
    ctx, _, _, _, jl, tl = _inputs()
    rng = jax.random.key(3)
    want = jm.apply(v, rng, jnp.asarray(ctx), jl,
                    method=J.DiffusionDecoder.infer)
    shape = (B, T, N_MEL)
    x0 = jax.random.normal(rng, shape)
    keys = jax.random.split(jax.random.fold_in(rng, 1), SCHEDULE["n_steps"])
    zs = jnp.stack([jax.random.normal(k, shape) for k in keys])
    got = port.infer(_t(ctx), tl, x=_t(x0), zs=_t(zs))
    _close(got, want, 1e-4)
    assert np.abs(got.detach().numpy()[1, LENGTHS[1]:]).max() == 0


def _attn(seed, T_mel, T_text=6):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.01, 1, (B, T_mel, T_text)).astype(np.float32)
    a /= a.sum(-1, keepdims=True)
    return {"attn": a, "attn_soft": a, "attn_logprob": np.log(a)}


def _text_lens(T_text=6):
    return (JaxSeqLens.create(jnp.asarray([6, 4]), T_text),
            SeqLens.create(_t([6, 4]), T_text))


def _losses_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k][0], want[k][0])
        assert got[k][1] == want[k][1], k


@pytest.mark.parametrize("binarization_on", [False, True])
def test_deterministic_loss(binarization_on):
    _, _, _, mel, jl, tl = _inputs()
    mel_hat = _inputs(1)[3]
    out = {"mel": mel, "mel_hat": mel_hat, **_attn(0, T)}
    ji, ti = _text_lens()
    want = JL.RADTTSDeterministicLoss()(
        {k: jnp.asarray(a) for k, a in out.items()}, ji, jl, binarization_on)
    got = PL.RADTTSDeterministicLoss()(
        {k: _t(a) for k, a in out.items()}, ti, tl, binarization_on)
    _losses_close(got, want)


def test_diffusion_loss():
    _, _, _, noise, jl, tl = _inputs()
    out = {"noise": noise, "noise_hat": _inputs(1)[3], **_attn(1, T)}
    ji, ti = _text_lens()
    want = JL.RADTTSDiffusionLoss()(
        {k: jnp.asarray(a) for k, a in out.items()}, ji, jl, False)
    got = PL.RADTTSDiffusionLoss()({k: _t(a) for k, a in out.items()}, ti,
                                   tl, False)
    _losses_close(got, want)


def test_e2e_gan_loss():
    want_out, got_out = _e2e()
    audio = (np.random.default_rng(5).standard_normal((B, 32 * 8)) * 0.1
             ).astype(np.float32)
    audio_lens = np.asarray([32 * 8, 20 * 8], np.float32)
    jl, tl = (JaxSeqLens.create(jnp.asarray([32, 20]), 32),
              SeqLens.create(_t([32, 20]), 32))
    ji, ti = _text_lens()
    attn = _attn(2, 32)
    kw = dict(fft_lengths=(64, 128, 32), hop_lengths=(16, 32, 8),
              win_lengths=(48, 128, 32))
    want = JL.RADTTSE2EGANLoss(**kw)(
        {**want_out, **{k: jnp.asarray(a) for k, a in attn.items()}},
        jnp.asarray(audio), jnp.asarray(audio_lens), ji, jl, True)
    got = PL.RADTTSE2EGANLoss(**kw)(
        {**got_out, **{k: _t(a) for k, a in attn.items()}}, _t(audio),
        _t(audio_lens), ti, tl, True)
    _losses_close(got, want)


# -- losses/stft_loss.py ----------------------------------------------------

def _audio(seed=0, n=1000):
    return (np.random.default_rng(seed).standard_normal((B, n)) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("fft,hop,win", [(256, 64, 256), (128, 30, 100),
                                         (64, 10, 50)])
def test_stft_magnitude_and_complex_stft(fft, hop, win):
    x = _audio()
    _close(PS.stft_magnitude(_t(x), fft, hop, win),
           JS.stft_magnitude(jnp.asarray(x), fft, hop, win))
    got = PS.complex_stft(_t(x), fft, hop, win)
    want = np.asarray(JS.complex_stft(jnp.asarray(x), fft, hop, win))
    _close(got.real, want.real, 1e-4)
    _close(got.imag, want.imag, 1e-4)


@pytest.mark.parametrize("ratios", [None, (1.0, 0.55)])
def test_spectral_convergence_and_log_magnitude(ratios):
    x, y = _audio(0), _audio(1)
    xm_j, ym_j = (JS.stft_magnitude(jnp.asarray(a), 128, 32, 128)
                  for a in (x, y))
    xm_p, ym_p = (PS.stft_magnitude(_t(a), 128, 32, 128) for a in (x, y))
    rj = None if ratios is None else jnp.asarray(ratios, jnp.float32)
    rp = None if ratios is None else torch.tensor(ratios)
    _close(PS.spectral_convergence_loss(xm_p, ym_p, rp),
           JS.spectral_convergence_loss(xm_j, ym_j, rj))
    for off in (0.0, 1.0):
        _close(PS.log_stft_magnitude_loss(xm_p, ym_p, rp, off),
               JS.log_stft_magnitude_loss(xm_j, ym_j, rj, off))


def test_a_weights():
    np.testing.assert_array_equal(PS.a_weights(22050, 512),
                                  JS.a_weights(22050, 512))


@pytest.mark.parametrize("a_weighting", [False, True])
def test_multi_resolution_stft_loss(a_weighting):
    x, y = _audio(0), _audio(1)
    kw = dict(fft_sizes=(128, 256, 64), hop_sizes=(32, 64, 16),
              win_lengths=(100, 256, 64), a_weighting=a_weighting)
    ratios = np.asarray([1.0, 0.6], np.float32)
    sc_j, mag_j = JS.MultiResolutionSTFTLoss(**kw)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(ratios))
    sc_p, mag_p = PS.MultiResolutionSTFTLoss(**kw)(_t(x), _t(y), _t(ratios))
    _close(sc_p, sc_j)
    _close(mag_p, mag_j)


def test_complex_stft_losses():
    x, y = _audio(0), _audio(1)
    kw = dict(fft_sizes=(128, 64), hop_sizes=(32, 16),
              win_lengths=(100, 64))
    _close(PS.ComplexSTFTLoss(128, 32, 100)(_t(x), _t(y)),
           JS.ComplexSTFTLoss(128, 32, 100)(jnp.asarray(x), jnp.asarray(y)))
    x3, y3 = x.reshape(1, B, -1), y.reshape(1, B, -1)
    _close(PS.MultiResolutionComplexSTFTLoss(**kw)(_t(x3), _t(y3)),
           JS.MultiResolutionComplexSTFTLoss(**kw)(jnp.asarray(x3),
                                                  jnp.asarray(y3)))
