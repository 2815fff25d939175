"""radmmm_torch models against the JAX package on copied weights, at the
tests' tiny config: TextEncoder, the attribute predictors, the flow's
sampling direction with an injected latent, and the two serving stages.

Tolerances: 1e-5 for single modules; 1e-4 for whole stages and the mel
(f32 on both sides, the difference is summation order, accumulated
through the encoder, the predictors and the flow inverses). Integer
outputs (durations, frame counts, voiced flags) must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
from radmmm_torch.models.flow_decoder import squeeze_time, unsqueeze_time
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.utils.masking import SeqLens
from tests.test_torch_convert import jax_tiny_tts, torch_tts
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
STAGE_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_tiny_tts()
    return jm, variables, torch_tts(jm, variables)


def _t(a):
    return torch.from_numpy(np.array(a))


def _text(rng, B=2, T=7, lens=(7, 4)):
    text = rng.integers(1, 30, (B, T)).astype(np.int32)
    return (text, np.asarray(lens, np.int32), np.asarray([0, 2], np.int32),
            np.asarray([1, 0], np.int32))


def test_squeeze_matches_unfold_order(rng):
    from radmmm_tpu.models.flow_decoder import squeeze_time as jsq
    x = rng.standard_normal((2, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(squeeze_time(_t(x), 2).numpy(),
                                  np.asarray(jsq(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        unsqueeze_time(squeeze_time(_t(x), 2), 2).numpy(), x[:, :8])


def test_text_encoder(models, rng):
    jm, v, port = models
    x = rng.standard_normal((2, 7, 18)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([[7], [4]])
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask),
                    method=lambda m, x, k: m.text_encoder(x, k, train=False))
    got = port.text_encoder(_t(x), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("name", ["duration_predictor", "f0_predictor",
                                  "energy_predictor", "voiced_predictor"])
def test_dap_infer(models, rng, name):
    jm, v, port = models
    B, T = 2, 11
    enc = rng.standard_normal((B, T, 18)).astype(np.float32)
    spk = rng.standard_normal((B, 4)).astype(np.float32)
    acc = rng.standard_normal((B, 2)).astype(np.float32)
    lens = np.array([11, 6], np.int32)
    f0m, f0s = np.array([5.0, 5.2], np.float32), np.array([.3, .4],
                                                         np.float32)
    want = jm.apply(
        v, jnp.asarray(enc), jnp.asarray(spk), jnp.asarray(lens),
        jnp.asarray(acc),
        method=lambda m, e, s, l, a: getattr(m, name).infer(
            e, s, JaxSeqLens.create(l, T), x_mean=f0m, x_std=f0s,
            accent_emb=a))
    got = getattr(port, name).infer(_t(enc), _t(spk),
                                    SeqLens.create(_t(lens), T), _t(f0m),
                                    _t(f0s), accent_emb=_t(acc))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_flow_infer_with_injected_residual(models, rng):
    jm, v, port = models
    B, Tt, F = 2, 5, 16
    spk = rng.standard_normal((B, 4)).astype(np.float32)
    txt = rng.standard_normal((B, Tt, 18)).astype(np.float32)
    dur = np.array([[3, 1, 4, 2, 2], [2, 2, 0, 3, 1]], np.int32)
    f0 = rng.uniform(4, 6, (B, F)).astype(np.float32)
    energy = rng.uniform(0, 1, (B, F)).astype(np.float32)
    out_lens = np.minimum(dur.sum(1), F).astype(np.int32)
    res = rng.standard_normal((B, F // 2, 16)).astype(np.float32) * 0.8
    want = jm.apply(
        v, jnp.asarray(spk), jnp.asarray(txt), jnp.asarray(dur),
        jnp.asarray(f0), jnp.asarray(energy), jnp.asarray(out_lens),
        jnp.asarray(res),
        method=lambda m, s, t, d, f, e, l, r: m.decoder.infer(
            None, s, t, 0.8, dur=d, f0=f, energy_avg=e,
            lens=JaxSeqLens.create(l, F), residual=r)["mel"])
    got = port.decoder.infer(_t(spk), _t(txt), 0.8, dur=_t(dur), f0=_t(f0),
                             energy_avg=_t(energy),
                             lens=SeqLens.create(_t(out_lens), F),
                             residual=_t(res))["mel"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=STAGE_ATOL)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_infer_durations(models, rng):
    jm, v, port = models
    text, lens, spk, acc = _text(rng)
    want = jm.apply(v, jnp.asarray(text), jnp.asarray(lens),
                    jnp.asarray(spk), accent_ids=jnp.asarray(acc),
                    method=JaxTTSModel.infer_durations)
    with torch.inference_mode():
        got = port.infer_durations(_t(text), _t(lens), _t(spk),
                                   accent_ids=_t(acc))
    np.testing.assert_allclose(got["txt_enc"].numpy(),
                               np.asarray(want["txt_enc"]), atol=STAGE_ATOL)
    # the durations before rounding, each side from its own encoder states
    pre_want = jm.apply(
        v, want["txt_enc"], jnp.asarray(spk), jnp.asarray(lens),
        jnp.asarray(acc),
        method=lambda m, e, s, l, a: m.duration_predictor.infer(
            e, m.encode_speaker(s), JaxSeqLens.create(l, 7),
            accent_emb=m.encode_accent(a)))
    with torch.inference_mode():
        pre_got = port.duration_predictor.infer(
            got["txt_enc"], port.speaker_embeddings(_t(spk)),
            SeqLens.create(_t(lens), 7),
            accent_emb=port.accent_embeddings(_t(acc)))
    np.testing.assert_allclose(pre_got.numpy(), np.asarray(pre_want),
                               atol=STAGE_ATOL)
    np.testing.assert_array_equal(got["durations"].numpy(),
                                  np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["n_frames"].numpy(),
                                  np.asarray(want["n_frames"]))


def _decode_kw():
    return dict(f0_mean=np.array([5.0, 5.2], np.float32),
                f0_std=np.array([0.3, 0.4], np.float32))


def test_infer_decode_on_jax_durations(models, rng):
    """Stage B from the JAX stage A outputs, sigma=0 (a zero latent on
    both sides, so no random numbers need to match)."""
    jm, v, port = models
    text, lens, spk, acc = _text(rng)
    a = jm.apply(v, jnp.asarray(text), jnp.asarray(lens), jnp.asarray(spk),
                 accent_ids=jnp.asarray(acc),
                 method=JaxTTSModel.infer_durations)
    kw = _decode_kw()
    want = jm.apply(v, jax.random.key(0), a["txt_enc"], a["durations"],
                    jnp.asarray(spk), accent_ids=jnp.asarray(acc),
                    f0_mean=kw["f0_mean"], f0_std=kw["f0_std"], sigma=0.0,
                    max_frames=48, method=JaxTTSModel.infer_decode)
    with torch.inference_mode():
        got = port.infer_decode(_t(a["txt_enc"]), _t(a["durations"]),
                                _t(spk), accent_ids=_t(acc),
                                f0_mean=_t(kw["f0_mean"]),
                                f0_std=_t(kw["f0_std"]), sigma=0.0,
                                max_frames=48)
    np.testing.assert_array_equal(got["lens"].lengths.numpy(),
                                  np.asarray(want["lens"].lengths))
    np.testing.assert_array_equal(got["voiced"].numpy(),
                                  np.asarray(want["voiced"]))
    for k in ("f0", "energy", "mel"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=STAGE_ATOL, err_msg=k)


def test_infer_at_sigma_zero(models, rng):
    jm, v, port = models
    text, lens, spk, acc = _text(rng)
    kw = _decode_kw()
    want = jm.apply(v, jax.random.key(3), jnp.asarray(text),
                    jnp.asarray(lens), jnp.asarray(spk),
                    accent_ids=jnp.asarray(acc), sigma=0.0, max_frames=64,
                    method=JaxTTSModel.infer, **kw)
    with torch.inference_mode():
        got = port.infer(_t(text), _t(lens), _t(spk), accent_ids=_t(acc),
                         f0_mean=_t(kw["f0_mean"]), f0_std=_t(kw["f0_std"]),
                         sigma=0.0, max_frames=64)
    np.testing.assert_array_equal(got["durations"].numpy(),
                                  np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["lens"].lengths.numpy(),
                                  np.asarray(want["lens"].lengths))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=STAGE_ATOL)


def test_ganged_frame_predictors_match_separate(models, rng):
    """One six-lane recurrence for voiced/f0/energy equals three separate
    predictor calls (port against itself)."""
    jm, v, port = models
    sep = TTSModel(TTSConfig(**dict(dataclasses.asdict(port.config),
                                    gang_frame_predictors=False)))
    sep.load_state_dict(port.state_dict())
    sep.eval().cache_inverses()
    text, lens, spk, acc = _text(rng)
    kw = {k: _t(a) for k, a in _decode_kw().items()}
    args = (_t(text), _t(lens), _t(spk))
    with torch.inference_mode():
        g = port.infer(*args, accent_ids=_t(acc), sigma=0.0, max_frames=64,
                       **kw)
        s = sep.infer(*args, accent_ids=_t(acc), sigma=0.0, max_frames=64,
                      **kw)
    for k in ("f0", "energy", "mel"):
        np.testing.assert_allclose(g[k].numpy(), s[k].numpy(), atol=ATOL)
    np.testing.assert_array_equal(g["voiced"].numpy(), s["voiced"].numpy())


@pytest.mark.parametrize("kw", [
    dict(target_offset=-5.0),
    dict(log_target=True, target_scale=2.0),
    dict(normalize_target=True, normalization_type="norm_lin_space"),
    dict(normalize_target=True, normalization_type="norm_log_space"),
])
def test_target_transforms(rng, kw):
    from radmmm_tpu.models import attributes as jax_attr
    from radmmm_torch.models import attributes as port_attr
    x = rng.uniform(1.0, 6.0, (2, 5, 1)).astype(np.float32)
    mean = np.array([5.0, 5.2], np.float32)
    std = np.array([0.3, 0.4], np.float32)
    for name in ("tx_target", "inv_tx_target"):
        want = getattr(jax_attr, name)(jnp.asarray(x), x_mean=mean,
                                       x_std=std, **kw)
        got = getattr(port_attr, name)(_t(x), x_mean=_t(mean),
                                       x_std=_t(std), **kw)
        # rtol: the lin-space inverse takes exp(3x), up to e^18 here, where
        # f32 keeps about 7 significant digits
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=1e-6, err_msg=name)
