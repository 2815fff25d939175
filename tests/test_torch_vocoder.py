"""radmmm_torch HiFi-GAN against the JAX package at small widths, on
copied, perturbed weights and inputs drawn from a numpy seed: the
generator with both heads, the MPD and MSD at odd and even lengths, the
GAN losses, the blur augmentation, the Denoiser, and one upstream-format
``g_*`` file read by both packages' ``get_vocoder`` and ``export``.

Tolerances: waveforms within 1e-5 (f32 convolutions on both sides in
another summation order); the iSTFTNet head's within 1e-7 absolute: its
frames hold magnitudes near 1, so f32 rounding there is about 1e-8, while
a random-weight head's output nearly cancels to 5e-4 and gives no scale
(numpy's symmetric Hann window also differs from jnp's in the last
place); discriminator scores and feature maps within 1e-5 of
each output's largest magnitude; the losses within rtol 1e-5; the blur
kernels bit for bit and the blurred mel within 1e-6."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.vocoder import hifigan as jh
from radmmm_tpu.vocoder import utils as jutils
from radmmm_torch.convert import (discriminator_state_dict_from_jax,
                                  hifigan_state_dict_from_jax)
from radmmm_torch.vocoder import hifigan as th
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
from radmmm_torch.vocoder.utils import get_audio_for_mels, get_vocoder
from tests.test_torch_convert import (SMALL_VOCODER, jax_small_vocoder,
                                      perturb, torch_vocoder)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ISTFT_VOCODER = dict(SMALL_VOCODER, gen_istft_n_fft=16, gen_istft_hop=4)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax(rng, resblock):
    gen, variables = jax_small_vocoder(resblock)
    mel = rng.standard_normal((2, 10, 8)).astype(np.float32)
    want = np.asarray(gen.apply(variables, jnp.asarray(mel)))
    with torch.inference_mode():
        got = torch_vocoder(variables, resblock)(torch.from_numpy(mel))
    assert got.shape == want.shape == (2, 10 * 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_hop_length_and_config_defaults():
    assert HiFiGANConfig().hop_length == jh.HiFiGANConfig().hop_length == 256
    assert (HiFiGANConfig(**SMALL_VOCODER).hop_length
            == jh.HiFiGANConfig(**SMALL_VOCODER).hop_length == 8)
    # the iSTFTNet head multiplies the hop by its own
    assert (HiFiGANConfig(**ISTFT_VOCODER).hop_length
            == jh.HiFiGANConfig(**ISTFT_VOCODER).hop_length == 32)
    assert Generator(HiFiGANConfig(**ISTFT_VOCODER)).conv_post_v.shape[0] \
        == 18


@functools.lru_cache(maxsize=None)
def _jax_istft_vocoder():
    gen = jh.Generator(config=jh.HiFiGANConfig(**ISTFT_VOCODER))
    variables = jax.jit(gen.init)(jax.random.key(3), jnp.zeros((1, 16, 8)))
    return gen, perturb(variables, seed=3)


@pytest.mark.parametrize("t_mel", [7, 10])
def test_istftnet_generator_matches_jax(rng, t_mel):
    """The iSTFTNet head: symmetric Hann window, exp of the clipped log
    magnitude, the centre trim padded back to T_mel x hop."""
    gen, variables = _jax_istft_vocoder()
    mel = rng.standard_normal((2, t_mel, 8)).astype(np.float32)
    want = np.asarray(gen.apply(variables, jnp.asarray(mel)))
    port = Generator(HiFiGANConfig(**ISTFT_VOCODER))
    port.load_state_dict(hifigan_state_dict_from_jax(variables))
    with torch.inference_mode():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, t_mel * 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _disc_pair(kind, T):
    """(JAX discriminator, its perturbed variables, the port's twin)."""
    jd = (jh.MultiPeriodDiscriminator() if kind == "mpd"
          else jh.MultiScaleDiscriminator())
    y = jnp.zeros((1, T))
    variables = perturb(jax.jit(jd.init)(jax.random.key(5), y, y), seed=5)
    port = th.MultiPeriodDiscriminator() if kind == "mpd" \
        else th.MultiScaleDiscriminator()
    port.load_state_dict(discriminator_state_dict_from_jax(variables))
    return jd, variables, port


def _close(got, want, scale_of=None):
    want = np.asarray(want)
    scale = np.abs(want if scale_of is None else scale_of).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(scale, 1e-30))


@pytest.mark.parametrize("kind", ["mpd", "msd"])
@pytest.mark.parametrize("T", [1023, 1024])
def test_discriminators_match_jax(rng, kind, T):
    """Scores and every feature map of real and generated audio, at an odd
    T (the MPD's reflect pad to a multiple of each period; the MSD's SAME
    pooling pads 1 and 2) and an even one (1 and 1); then the three GAN
    losses on those outputs."""
    jd, variables, port = _disc_pair(kind, T)
    y = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    y_hat = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    want = jax.jit(jd.apply)(variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    for w_list, g_list in zip(want[:2], got[:2]):          # scores
        assert len(w_list) == len(g_list)
        for w, g in zip(w_list, g_list):
            assert g.shape == w.shape
            _close(g, w)
    for w_maps, g_maps in zip(want[2] + want[3], got[2] + got[3]):
        for w, g in zip(w_maps, g_maps):                    # NHWC / NWC
            w = np.asarray(w)
            w = (w.transpose(0, 3, 1, 2) if w.ndim == 4
                 else w.transpose(0, 2, 1))
            assert tuple(g.shape) == w.shape
            _close(g, w)
    outs_r, outs_g, fr, fg = want
    for jf, tf, args in (
            (jh.discriminator_loss, th.discriminator_loss, (0, 1)),
            (jh.generator_adv_loss, th.generator_adv_loss, (1,)),
            (jh.feature_loss, th.feature_loss, (2, 3))):
        np.testing.assert_allclose(float(tf(*[got[a] for a in args])),
                                   float(jf(*[want[a] for a in args])),
                                   rtol=1e-5)


@pytest.mark.parametrize("T", [9, 10])
def test_msd_pooling_is_xla_same(T):
    """Window 4, stride 2, zero padding 1 / 1 (even T) or 1 / 2 (odd T)
    that counts in the mean."""
    x = np.arange(1, 2 * T + 1, dtype=np.float32).reshape(2, T)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 4),
                                 (1, 2), "SAME") / 4.0
    got = th._pool_same(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_blur_kernels_are_exact():
    for size, sigmas in (((5, 5), (0.5, 1.0, 1.5, 2.0)), ((3, 5), (0.7,))):
        want = np.asarray(jh.gaussian_blur_kernels(size, sigmas))
        got = th.gaussian_blur_kernels(size, sigmas).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_blur_augment_matches_jax(rng, p):
    """A non-square (3 mel x 5 time) kernel, so a transposed layout would
    show; one sigma, so both frameworks' different draws pick the same
    kernel."""
    kernels = jh.gaussian_blur_kernels((3, 5), (0.9,))
    mel = rng.standard_normal((2, 12, 7)).astype(np.float32)
    want = np.asarray(jh.gaussian_blur_augment(
        jnp.asarray(mel), jax.random.key(0), kernels, p))
    got = th.gaussian_blur_augment(
        torch.from_numpy(mel), th.blur_generator(0, 3),
        th.gaussian_blur_kernels((3, 5), (0.9,)), p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if p == 0.0:
        np.testing.assert_array_equal(got, mel)
    else:
        assert np.abs(got - mel).max() > 0.1


def test_blur_draws_are_keyed_by_seed_and_step():
    def draws(seed, step):
        g = th.blur_generator(seed, step)
        return [float(torch.rand((), generator=g)) for _ in range(3)]
    assert draws(0, 5) == draws(0, 5)
    assert draws(0, 5) != draws(0, 6) and draws(0, 5) != draws(1, 5)


def test_denoiser_matches_jax(rng):
    gen, variables = jax_small_vocoder("1")
    port = torch_vocoder(variables, "1")
    want_den = jh.Denoiser(gen.apply, variables, n_mel_channels=8)
    got_den = th.Denoiser(lambda m: port(m), n_mel_channels=8, device="cpu")
    np.testing.assert_allclose(got_den.bias_spec.detach().numpy(),
                               np.asarray(want_den.bias_spec), rtol=1e-4,
                               atol=1e-6)
    mel = rng.standard_normal((2, 80, 8)).astype(np.float32)
    audio = np.array(gen.apply(variables, jnp.asarray(mel)))
    want = np.asarray(want_den(jnp.asarray(audio), strength=0.5))
    with torch.no_grad():
        got = got_den(torch.from_numpy(audio), strength=0.5).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_denoiser_runs_on_the_card_unless_given_the_cpu():
    """The Denoiser makes its bias spectrum on the card by default, as the
    other entry points do; without one it raises unless asked for the
    CPU, where it holds the bias spectrum of the CPU generator."""
    _, variables = jax_small_vocoder("1")
    port = torch_vocoder(variables, "1")
    den = th.Denoiser(lambda m: port(m), n_mel_channels=8, device="cpu")
    assert den.bias_spec.device.type == "cpu"
    assert den.bias_spec.shape == (1, 1, 513)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.Denoiser(lambda m: port(m), n_mel_channels=8)


def _write_g_file(tmp_path, config, seed=11):
    """An upstream-format ``g_*`` file and its config json, from seeded
    random weights (biases and g moved off their inits)."""
    import json
    torch.manual_seed(seed)
    gen = Generator(config)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith(("_bias", "_g")):
                p.add_(0.01 * torch.randn_like(p))
    path = tmp_path / "g_00000042"
    torch.save({"generator": th.upstream_generator_state_dict(gen)}, path)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "resblock": config.resblock,
        "upsample_rates": list(config.upsample_rates),
        "upsample_kernel_sizes": list(config.upsample_kernel_sizes),
        "upsample_initial_channel": config.upsample_initial_channel,
        "resblock_kernel_sizes": list(config.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in
                                    config.resblock_dilation_sizes],
        "num_mels": config.n_mel_channels, "sampling_rate": 16000}))
    return str(path), str(cfg), gen


def test_upstream_g_file_read_by_both_packages(rng, tmp_path):
    """One ``g_*`` file through both ``get_vocoder``s (the JAX package
    reads it with torch.load): equal audio with and without the Denoiser;
    ``load_hifigan_module`` gives the generator the file was written
    from."""
    from radmmm_torch.vocoder.utils import load_hifigan_module
    path, cfg, gen = _write_g_file(tmp_path, HiFiGANConfig(**SMALL_VOCODER))
    jfn, jden = jutils.get_vocoder("hifigan", cfg, path)
    tfn, tden = get_vocoder("hifigan", cfg, path, device="cpu")
    mel = rng.standard_normal((2, 80, 8)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(mel)))
    got = tfn(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    want = np.asarray(jutils.get_audio_for_mels(jnp.asarray(mel), "hifigan",
                                                jfn, jden, 0.1))
    got = get_audio_for_mels(torch.from_numpy(mel), "hifigan", tfn, tden,
                             0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    loaded = load_hifigan_module(cfg, path)
    assert loaded.config.sampling_rate == 16000
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_get_vocoder_dispatch(tmp_path):
    assert get_vocoder("hifigan", None, None) == (None, None)
    assert get_vocoder("hifigan", None, str(tmp_path / "missing")) == \
        (None, None)
    with pytest.raises(ValueError, match="unsupported"):
        get_vocoder("melgan", None, None)
    path, cfg, _ = _write_g_file(tmp_path, HiFiGANConfig(**SMALL_VOCODER))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_vocoder("hifigan", cfg, path)
    fn, den = get_vocoder("hifigan", cfg, path, with_denoiser=False,
                          device="cpu")
    assert den is None and fn(np.zeros((1, 4, 8), np.float32)).shape == \
        (1, 32)
