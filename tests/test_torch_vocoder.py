"""radmmm_torch HiFi-GAN generator against the JAX generator on copied,
perturbed weights at a small config. Tolerance 1e-5 on the waveform
(f32 convolutions on both sides; summation order differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.vocoder.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tests.test_torch_convert import (SMALL_VOCODER, jax_small_vocoder,
                                      torch_vocoder)


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
    assert HiFiGANConfig().hop_length == JaxHiFiGANConfig().hop_length == 256
    assert (HiFiGANConfig(**SMALL_VOCODER).hop_length
            == JaxHiFiGANConfig(**SMALL_VOCODER).hop_length == 8)
    with pytest.raises(ValueError, match="iSTFTNet"):
        Generator(HiFiGANConfig(gen_istft_n_fft=16))
