"""radmmm_torch WaveGlow against the JAX package at a tiny width (4 flows
of group 4, early exits every 2, WN 16 channels x 2 layers, 8 mel
channels), on copied weights with every leaf perturbed (``end`` starts
at zero) and inputs drawn from a numpy seed: ``InvertibleConv``, the
forward direction, ``infer(residual=forward(...)["z"])``,
``waveglow_loss``, one upstream-format file read by both packages'
``get_vocoder`` (weight-normed and plain), and ``WaveGlowTrainer`` over 3
steps from one state carried across by ``convert.py``.

Tolerances: z and the audio within 1e-5 of their largest magnitude, each
flow's summed log_s and log-det within 1e-4 absolute (sums of up to 2,048
f32 terms), the loss within rtol 1e-5; the trainer's loss each step
within rtol 1e-5 and its parameters after 3 Adam steps within 1e-6
absolute (three steps of at most lr 1e-3 each; where a gradient is near
zero its Adam update is near its sign, so the bound is on the update's
rounding, not on the gradient's)."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.ops.invertible import InvertibleConv as JaxInvertibleConv
from radmmm_tpu.training import vocoder_train as jvt
from radmmm_tpu.vocoder import utils as jutils
from radmmm_tpu.vocoder import waveglow as jwg
from radmmm_torch.convert import (load_jax_vocoder_state,
                                  waveglow_state_dict_from_jax)
from radmmm_torch.ops.invertible import InvertibleConv
from radmmm_torch.training import vocoder_train as tvt
from radmmm_torch.vocoder import waveglow as twg
from radmmm_torch.vocoder.utils import get_audio_for_mels, get_vocoder
from tests.test_torch_convert import perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TINY = dict(n_mel_channels=8, n_flows=4, n_group=4, n_early_every=2,
            n_early_size=2, wn_channels=16, wn_layers=2, hop_length=64,
            upsample_kernel=128)
B, T_MEL = 2, 8


@functools.lru_cache(maxsize=None)
def jax_tiny():
    model = jwg.WaveGlow(**TINY)
    audio = jnp.zeros((1, T_MEL * TINY["hop_length"]))
    mel = jnp.zeros((1, T_MEL, TINY["n_mel_channels"]))
    variables = jax.jit(model.init)(jax.random.key(0), audio, mel)
    return model, perturb(variables, seed=2)


def torch_tiny(variables) -> twg.WaveGlow:
    port = twg.WaveGlow(**TINY)
    port.load_state_dict(waveglow_state_dict_from_jax(variables))
    return port


def _inputs(rng):
    audio = (rng.standard_normal((B, T_MEL * TINY["hop_length"]))
             * 0.1).astype(np.float32)
    mel = rng.standard_normal((B, T_MEL, 8)).astype(np.float32)
    return audio, mel


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_every_leaf_maps_to_one_port_tensor():
    _, variables = jax_tiny()
    sd = waveglow_state_dict_from_jax(variables)
    want = twg.WaveGlow(**TINY).state_dict()
    assert set(sd) == set(want), set(sd) ^ set(want)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables["params"]))
    for k, v in sd.items():
        assert v.shape == want[k].shape, k


@pytest.mark.parametrize("seed", [0, 5])
def test_invertible_conv_matches_jax(rng, seed):
    """The same W from the host LU factors at init_seed + 104729, its
    mix, slogdet and float32 inverse."""
    jm = JaxInvertibleConv(6, init_seed=seed)
    z = rng.standard_normal((2, 5, 6)).astype(np.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(z))
    port = InvertibleConv(6, init_seed=seed)
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  np.asarray(variables["params"]["weight"]))
    y, logdet = jm.apply(variables, jnp.asarray(z))
    with torch.no_grad():
        got_y, got_logdet = port(torch.from_numpy(z))
        back = port.inverse(got_y)
    _close(got_y, y)
    np.testing.assert_allclose(float(got_logdet), float(logdet), atol=1e-6)
    want_back = jm.apply(variables, y, inverse=True)
    _close(back, want_back)
    _close(back, z)


def test_forward_and_loss_match_jax(rng):
    """z, each flow's log_s and 1x1 log-det, and the NLL (whose log-det
    counts once per grouped frame)."""
    model, variables = jax_tiny()
    audio, mel = _inputs(rng)
    want = model.apply(variables, jnp.asarray(audio), jnp.asarray(mel))
    port = torch_tiny(variables)
    with torch.no_grad():
        got = port(torch.from_numpy(audio), torch.from_numpy(mel))
    assert got["z"].shape == want["z"].shape == (B, 128, 4)
    _close(got["z"], want["z"])
    for g, w in zip(got["log_s_list"], want["log_s_list"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(float(g.sum()), float(jnp.sum(w)),
                                   atol=1e-4)
    for g, w in zip(got["log_det_W_list"], want["log_det_W_list"]):
        np.testing.assert_allclose(float(g), float(w), atol=1e-4)
    np.testing.assert_allclose(
        float(twg.waveglow_loss(got, sigma=0.8)),
        float(jwg.waveglow_loss(want, sigma=0.8)), rtol=1e-5)


def test_upsample_mel_is_channel_major(rng):
    model, variables = jax_tiny()
    mel = rng.standard_normal((B, T_MEL, 8)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(mel), 500,
                       method=jwg.WaveGlow.upsample_mel)
    with torch.no_grad():
        got = torch_tiny(variables).upsample_mel(torch.from_numpy(mel), 500)
    assert got.shape == want.shape == (B, 125, 32)
    _close(got, want)


def test_infer_with_residual_matches_jax_and_rebuilds_audio(rng):
    model, variables = jax_tiny()
    audio, mel = _inputs(rng)
    z = model.apply(variables, jnp.asarray(audio), jnp.asarray(mel))["z"]
    want = model.apply(variables, jax.random.key(0), jnp.asarray(mel),
                       residual=z, method=jwg.WaveGlow.infer)
    port = torch_tiny(variables)
    with torch.no_grad():
        got = port.infer(torch.from_numpy(mel),
                         residual=torch.from_numpy(np.array(z)))
        z_port = port(torch.from_numpy(audio), torch.from_numpy(mel))["z"]
        rebuilt = port.infer(torch.from_numpy(mel), residual=z_port)
    assert got.shape == want.shape == audio.shape
    _close(got, want)
    _close(rebuilt, audio, rel=1e-4)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_upstream_file_read_by_both_packages(rng, tmp_path, weight_norm):
    """One file in the vendored tree's format, written from the port's
    copy of the perturbed weights, weight-normed or remove_weightnorm'd,
    with its train config: both ``get_vocoder``s give equal audio at
    sigma 0, and with their Denoisers, which run the generator at
    sigma 0."""
    _, variables = jax_tiny()
    path = tmp_path / "waveglow.pt"
    torch.save({"model": twg.upstream_waveglow_state_dict(
        torch_tiny(variables), weight_norm=weight_norm)}, path)
    assert any(k.endswith("weight_g") for k in torch.load(path)["model"]) \
        == weight_norm
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "waveglow_config": {
            "n_mel_channels": 8, "n_flows": 4, "n_group": 4,
            "n_early_every": 2, "n_early_size": 2, "upsample_kernel": 128,
            "WN_config": {"n_layers": 2, "n_channels": 16,
                          "kernel_size": 3}},
        "data_config": {"hop_length": 64}}))
    jfn, jden = jutils.get_vocoder("waveglow", str(cfg), str(path))
    tfn, tden = get_vocoder("waveglow", str(cfg), str(path), device="cpu")
    mel = rng.standard_normal((1, 24, 8)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(mel), sigma=0.0))
    got = tfn(torch.from_numpy(mel), sigma=0.0).numpy()
    assert got.shape == want.shape == (1, 24 * 64)
    _close(got, want)
    want = jutils.get_audio_for_mels(
        jnp.asarray(mel), "waveglow", lambda m: jfn(m, sigma=0.0), jden, 0.1)
    got = get_audio_for_mels(torch.from_numpy(mel), "waveglow",
                             lambda m: tfn(m, sigma=0.0), tden, 0.1)
    _close(got, want)
    # the default draw: sigma 0.667 from a generator seeded 0, the same
    # noise on every call
    np.testing.assert_array_equal(tfn(mel).numpy(), tfn(mel).numpy())


def test_config_loader_matches_jax(tmp_path):
    cfg = {"waveglow_config": {"n_flows": 6, "n_group": 8,
                               "WN_config": {"n_layers": 4,
                                             "n_channels": 64}},
           "data_config": {"hop_length": 160}}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    assert twg.load_waveglow_config(str(p)) == \
        jwg.load_waveglow_config(str(p)) == {
            "n_flows": 6, "n_group": 8, "wn_layers": 4, "wn_channels": 64,
            "hop_length": 160}
    assert twg.load_waveglow_config(None) == {}


def test_trainer_matches_jax_over_3_steps(rng):
    """Both trainers from one (perturbed) JAX state: the loss each step
    and every parameter after 3 steps of Adam at 1e-3."""
    wg_cfg = {k: v for k, v in TINY.items() if k != "hop_length"}
    cfg = jvt.VocoderTrainConfig(segment_size=512, hop_length=64,
                                 filter_length=256, win_length=256,
                                 n_mel_channels=8, learning_rate=1e-3)
    jtr = jvt.WaveGlowTrainer(wg_cfg, cfg)
    audio, mel = _inputs(rng)
    batch = {"audio": jnp.asarray(audio), "mel": jnp.asarray(mel)}
    state = jtr.init_state(jax.random.key(0), batch)
    params = perturb({"params": state.params}, seed=4)["params"]
    state = jvt.WaveGlowTrainState(step=state.step, params=params,
                                   opt_state=jtr.tx.init(params))
    port = tvt.WaveGlowTrainer(wg_cfg, tvt.VocoderTrainConfig(
        **vars(cfg)), device="cpu")
    load_jax_vocoder_state(port, jax.tree_util.tree_map(np.asarray, state))
    tbatch = {"audio": torch.from_numpy(audio), "mel": torch.from_numpy(mel)}
    for _ in range(3):
        state, want = jtr.train_step(state, batch)
        got = port.train_step(tbatch)
        assert set(got) == set(want) == {"gen_loss", "nll"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5)
    assert port.step == int(state.step) == 3
    want_sd = waveglow_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)})
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
