"""The port's featurizer slice against the JAX package: the log-mel, the
beta-binomial prior, YIN and pYIN, ``collate_host``, ``Featurizer``, its
noise schedule and ``BucketBatcher``; then the slice as a whole, one
tiny-config training step from a featurized batch and ``reconstruct`` at
sigma 0, against the JAX package's featurize + step on copied weights.

Tolerances: the log-mel 1e-4 absolute and the STFT magnitude 1e-5
relative (f32 FFTs of two libraries); the prior 1e-4 relative (the JAX
package's f32 betaln against float64 lgamma here); F0 1e-4 relative where
both sides call the frame voiced, the voicing equal, p_voiced 1e-5 (sums
of the same f32 weights); energy 1e-5; the training step's loss terms as
in test_torch_training.py (1e-4); the reconstructed mel 1e-4."""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.data import collate as jax_collate
from radmmm_tpu.data import pitch as jax_pitch
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.ops import priors as jax_priors
from radmmm_tpu.ops import stft as jax_stft
from radmmm_tpu.training import optim as jax_optim
from radmmm_tpu.training import step as jax_step
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.data import collate, pitch
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.ops import priors, stft
from radmmm_torch.training import step
from radmmm_torch.utils.launches import launch_counts
from tests.test_torch_convert import perturb
from tests.test_tts_model import tiny_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SR = 22050
REPO = Path(__file__).resolve().parents[1]


def _glide(n, f_start=150.0, f_rate=150.0):
    """A glide with 5 Hz vibrato and a second harmonic."""
    t = np.arange(n) / SR
    phase = 2 * np.pi * (f_start * t + 0.5 * f_rate * t ** 2) \
        + 0.3 * np.sin(2 * np.pi * 5 * t)
    return (0.5 * np.sin(phase) + 0.35 * np.sin(2 * phase)).astype(np.float32)


def _signals(rng, n):
    """(3, n): a glide with vibrato, silence, noise."""
    return np.stack([_glide(n), np.zeros(n, np.float32),
                     0.3 * rng.standard_normal(n).astype(np.float32)])


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128)])
def test_mel_spectrogram_matches_jax(rng, n_fft, hop):
    y = rng.standard_normal((2, 8192)).astype(np.float32) * 0.3
    kw = dict(filter_length=n_fft, hop_length=hop, win_length=n_fft,
              mel_fmax=8000.0)
    jm, tm = jax_stft.MelSpectrogram(**kw), stft.MelSpectrogram(**kw)
    yt = torch.from_numpy(y)
    mag = tm.stft_magnitude(yt).numpy()
    np.testing.assert_allclose(mag, np.asarray(jm.stft_magnitude(y)),
                               rtol=1e-5, atol=1e-4)
    got = tm(yt).numpy()
    assert got.shape == (2, tm.n_frames(8192), 80)
    np.testing.assert_allclose(got, np.asarray(jm(y)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("sr", [22050, 16000])
def test_mel_basis_matches_the_goldens(sr):
    golden = np.load(REPO / "assets" / "mel_basis_goldens.npz")[
        f"sr{sr}_fft1024_mel80_fmin0_fmax8000"]
    fb64 = stft.mel_filterbank(sr, 1024, 80, 0.0, 8000.0, dtype=np.float64)
    assert np.abs(fb64 - golden).max() < 1e-12
    np.testing.assert_array_equal(
        stft.mel_filterbank(sr, 1024, 80, 0.0, 8000.0),
        jax_stft.mel_filterbank(sr, 1024, 80, 0.0, 8000.0))


def test_framing_and_compression_match_jax(rng):
    y = rng.standard_normal((2, 2048)).astype(np.float32)
    np.testing.assert_array_equal(
        stft.frame_signal(torch.from_numpy(y), 1024, 256).numpy(),
        np.asarray(jax_stft.frame_signal(jnp.asarray(y), 1024, 256)))
    x = np.array([1e-9, 1e-5, 0.5, 3.0], np.float32)
    np.testing.assert_allclose(
        stft.dynamic_range_compression(torch.from_numpy(x)).numpy(),
        np.asarray(jax_stft.dynamic_range_compression(x)), rtol=1e-6)
    np.testing.assert_allclose(
        stft.dynamic_range_decompression(torch.from_numpy(x)).numpy(),
        np.asarray(jax_stft.dynamic_range_decompression(x)), rtol=1e-6)


def test_beta_binomial_prior_matches_jax():
    """Text lengths 1, 5 and 16 of 16; mel lengths 7, 20 and 32 of 32;
    and the unbatched form."""
    tl, ml = np.array([1, 5, 16], np.int32), np.array([7, 20, 32], np.int32)
    want = np.asarray(jax_priors.beta_binomial_prior(
        jnp.asarray(tl), jnp.asarray(ml), max_text=16, max_mel=32))
    got = priors.beta_binomial_prior(torch.from_numpy(tl),
                                     torch.from_numpy(ml), 16, 32).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 32, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-30)
    np.testing.assert_allclose(got[0, :7, 0], 1.0, rtol=1e-6)  # one token
    assert (got[0, 7:] == 0).all() and (got[1, :, 5:] == 0).all()
    one = priors.beta_binomial_prior(torch.tensor(5), torch.tensor(9), 8, 12)
    np.testing.assert_allclose(one.numpy(), np.asarray(
        jax_priors.beta_binomial_prior(5, 9, max_text=8, max_mel=12)),
        rtol=1e-4, atol=1e-30)


def _assert_f0_close(got, want, what):
    f0, v, pv = (t.numpy() for t in got)
    jf0, jv, jpv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(v, jv, err_msg=f"{what} voicing")
    both = (v > 0) & (jv > 0)
    np.testing.assert_allclose(f0[both], jf0[both], rtol=1e-4,
                               err_msg=f"{what} f0")
    assert (f0[~both] == 0).all() and (jf0[~both] == 0).all()
    np.testing.assert_allclose(pv, jpv, atol=1e-5, rtol=0,
                               err_msg=f"{what} p_voiced")
    return v


@pytest.mark.parametrize("method", ["yin_f0", "pyin_f0"])
def test_f0_matches_jax(rng, method):
    """0.6 s each of a glide with vibrato, silence and noise. The voicing
    is a Viterbi decision, and a frame where two paths tie can flip on the
    last bit of an f32 sum: at the onset of a tone after silence, p_voiced
    read 1.0 in JAX and 0.99999994 here, which moves the unvoiced
    log-likelihood from log 1e-10 to log 3.3e-10 and the frame to the
    unvoiced path. No frame of these signals is such a tie."""
    sig = _signals(rng, int(0.6 * SR))
    want = getattr(jax_pitch, method)(jnp.asarray(sig), sampling_rate=SR)
    got = getattr(pitch, method)(torch.from_numpy(sig), sampling_rate=SR)
    v = _assert_f0_close(got, want, method)
    assert v[0, 5:-5].mean() > 0.8 and v[1].max() == 0     # voiced; silent


def test_viterbi_takes_its_twin_on_the_cpu():
    """CPU tensors run ``viterbi_reference`` and launch no kernel."""
    g = torch.Generator().manual_seed(0)
    log_obs, log_P, log_V = (torch.log(torch.rand(shape, generator=g))
                             for shape in ((2, 6, 2, 7), (7, 7), (2, 2)))
    before = launch_counts["pyin_viterbi"]
    got = pitch.viterbi(log_obs, log_P, log_V)
    want = pitch.viterbi_reference(log_obs, log_P, log_V)
    assert launch_counts["pyin_viterbi"] == before
    for a, b in zip(got, want):
        assert a.dtype == torch.int64 and a.shape == (2, 6)
        assert torch.equal(a, b)


def _items(rng, B=3, n_text=12, seconds=(0.5, 0.35, 0.42)):
    items = []
    for b in range(B):
        n = int(seconds[b] * SR)
        audio = _glide(n, 140.0 + 40 * b, 60.0)
        audio[n // 2:n // 2 + n // 6] = 0.0                 # a gap
        audio += 0.003 * rng.standard_normal(n).astype(np.float32)
        items.append({
            "audio": audio, "text_encoded": rng.integers(1, 30, n_text - b),
            "speaker_id": b % 3, "accent_id": b % 2,
            "speaker_f0_mean": 5.0, "speaker_f0_std": 0.3,
            "speaker_energy_mean": 0.5, "speaker_energy_std": 0.15,
            "audiopath": f"u{b}.wav", "text_raw": "x", "language": "en_US",
            "idx": b})
    return items


def test_collate_host_matches_jax(rng):
    items = _items(rng)
    for it in items:
        it["cached_f0"] = rng.standard_normal((3, 20)).astype(np.float32)
    for kw in ({}, {"pad_to": (24, 10)}):
        got = collate.collate_host(items, audio_frames_multiple=16, **kw)
        want = jax_collate.collate_host(items, audio_frames_multiple=16,
                                        **kw)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=k)
    assert collate.collate_host([None]) is None


@pytest.mark.parametrize("distance_tx_unvoiced,cached", [
    (False, False), (True, False), (False, True)])
def test_featurizer_matches_jax(rng, distance_tx_unvoiced, cached):
    items = _items(rng)
    if cached:
        for it in items:
            n = 1 + len(it["audio"]) // 256
            it["cached_f0"] = np.stack([
                rng.uniform(100, 300, n), rng.integers(0, 2, n),
                rng.uniform(0, 1, n)]).astype(np.float32)
    host = collate.collate_host(items, audio_frames_multiple=16)
    got = collate.Featurizer(device="cpu",
                             distance_tx_unvoiced=distance_tx_unvoiced)(host)
    want = jax_collate.Featurizer(
        distance_tx_unvoiced=distance_tx_unvoiced)(host)
    assert set(got) == set(want)
    for k in ("audio", "text", "input_lengths", "output_lengths",
              "speaker_ids", "accent_ids", "idx", "speaker_f0_mean"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["audiopaths"] == want["audiopaths"]
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["energy_avg"].numpy(),
                               np.asarray(want["energy_avg"]), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["attn_prior"].numpy(),
                               np.asarray(want["attn_prior"]), rtol=1e-4,
                               atol=1e-30)
    np.testing.assert_array_equal(got["voiced_mask"].numpy(),
                                  np.asarray(want["voiced_mask"]))
    np.testing.assert_allclose(got["p_voiced"].numpy(),
                               np.asarray(want["p_voiced"]), atol=1e-5,
                               rtol=0)
    # log F0, and with the distance transform the negative unvoiced values
    np.testing.assert_allclose(got["f0"].numpy(), np.asarray(want["f0"]),
                               rtol=1e-4, atol=1e-5)
    if not cached:
        assert got["voiced_mask"].sum() > 0.5 * got["output_lengths"].sum()
    if distance_tx_unvoiced:
        assert got["f0"].min() < 0


def test_mel_noise_schedule(rng):
    """Fresh noise on every call, replayed by a featurizer of the same
    seed; set_noise_base re-keys the stream; a step's key replays and
    differs from the next step's; the noise has the configured scale."""
    host = collate.collate_host(_items(rng, B=2), audio_frames_multiple=16)
    kw = dict(device="cpu", f0_method="yin", seed=7)
    clean = collate.Featurizer(**kw)(host)["mel"]
    feat = collate.Featurizer(mel_noise_scale=0.05, **kw)
    m1, m2 = feat(host)["mel"], feat(host)["mel"]
    assert not torch.equal(m1, m2)
    assert torch.equal(collate.Featurizer(mel_noise_scale=0.05, **kw)(host)
                       ["mel"], m1)
    feat.set_noise_base(100)
    m3 = feat(host)["mel"]
    assert not torch.equal(m3, m1) and not torch.equal(m3, m2)
    feat.set_noise_base(100)
    assert torch.equal(feat(host)["mel"], m3)
    assert feat.noise_key_for_step(3) == feat.noise_key_for_step(3)
    assert feat.noise_key_for_step(3) != feat.noise_key_for_step(4)
    assert feat.noise_key_for_step(3) != collate.Featurizer(
        mel_noise_scale=0.05, device="cpu", seed=8).noise_key_for_step(3)
    raw = {k: torch.from_numpy(v) for k, v in feat.raw_arrays(host).items()}
    s3 = feat.featurize_raw(raw, feat.noise_key_for_step(3))
    assert torch.equal(s3["mel"], feat.featurize_raw(
        raw, feat.noise_key_for_step(3))["mel"])
    valid = s3["output_lengths"]
    noise = torch.cat([(m1 - clean)[i, :valid[i]] for i in range(2)])
    assert abs(noise.std().item() - 0.05) < 0.005


@pytest.mark.parametrize("shuffle", [False, True])
def test_bucket_batcher_order_matches_jax(shuffle):
    lengths = np.random.default_rng(0).uniform(1.0, 10.0, 50)
    got = collate.BucketBatcher(lengths, 4, shuffle=shuffle, seed=3,
                                bucket_window_batches=3)
    want = jax_collate.BucketBatcher(lengths, 4, shuffle=shuffle, seed=3,
                                     bucket_window_batches=3)
    assert len(got) == len(want) == 13
    for _ in range(2):                                  # two epochs
        assert list(got) == list(want)


# ---- the slice as a whole --------------------------------------------------

FEAT = dict(filter_length=256, hop_length=64, win_length=256,
            n_mel_channels=8, f0_min=120.0, f0_max=500.0)
REG = dict(cross_covariance_weight=1.0,
           speaker_reg={"variance": 1.0, "covariance": 1.0},
           accent_reg={"variance": 0.5, "covariance": 0.5})


@pytest.fixture(scope="module")
def featurized():
    """A seeded host batch of 2 utterances featurized by both packages,
    and the tiny JAX model (dropout off) with perturbed weights."""
    rng = np.random.default_rng(11)
    host = collate.collate_host(_items(rng, B=2, n_text=7,
                                       seconds=(0.19, 0.16)),
                                hop_length=64, audio_frames_multiple=16)
    jbatch = jax_collate.Featurizer(**FEAT)(host)
    batch = collate.Featurizer(device="cpu", **FEAT)(host)
    cfg = tiny_config(encoder_p_dropout=0.0)
    cfg = dataclasses.replace(cfg, **{
        k: dict(getattr(cfg, k), p_dropout=0.0)
        for k in ("f0_predictor", "energy_predictor", "voiced_predictor",
                  "duration_predictor")})
    jm = JaxTTSModel(config=cfg)
    keys = ("text", "input_lengths", "mel", "output_lengths", "speaker_ids",
            "accent_ids", "f0", "voiced_mask", "energy_avg", "attn_prior",
            "speaker_f0_mean", "speaker_f0_std")
    jbatch = {k: jbatch[k] for k in keys}
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jbatch)
    return jm, perturb(v), jbatch, {k: batch[k] for k in keys}


def _port(jm, v):
    port = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    return port


def test_training_step_from_a_featurized_batch_matches_jax(featurized):
    """binarize and kl on: JAX featurize + step against the port's."""
    jm, v, jbatch, batch = featurized
    tx = jax_optim.build_optimizer("RAdam", learning_rate=1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats={}, spectral=v["spectral"], opt_state=tx.init(params))
    jfn = jax.jit(jax_step.make_train_step(
        jm, jax_step.LossConfig(**REG), tx, binarize=True, kl_on=True))
    _, jmet = jfn(jstate, jbatch, jax.random.key(0))
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu", learning_rate=1e-3)
    _, met = step.make_train_step(port, step.LossConfig(**REG), True, True)(
        state, batch, torch.Generator())
    assert set(met) == set(jmet)
    for name, val in met.items():
        np.testing.assert_allclose(val.item(), float(jmet[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_reconstruct_matches_jax(featurized):
    """sigma 0: the MAS durations and the mel from ground-truth F0 and
    energy."""
    jm, v, jbatch, batch = featurized
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, v),
                    jax.random.key(5), jbatch, 0.0,
                    method=JaxTTSModel.reconstruct)
    port = _port(jm, v).eval().cache_inverses()
    with torch.inference_mode():
        got = port.reconstruct(batch, sigma=0.0)
    np.testing.assert_array_equal(got["durations"].numpy(),
                                  np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["durations"].sum(1).numpy(),
                                  batch["output_lengths"].numpy())
    np.testing.assert_array_equal(got["attn"].numpy(),
                                  np.asarray(want["attn"]))
    np.testing.assert_allclose(got["attn_soft"].numpy(),
                               np.asarray(want["attn_soft"]), atol=1e-5)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=1e-4, rtol=0)
