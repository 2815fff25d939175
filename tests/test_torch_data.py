"""radmmm_torch's data path against the JAX package's: the wave
transforms, dataset items with the recipe's formant augmentation on, the
loader's batches in order with and without shape runs, the data module,
and the inference transcripts (``TextOnlyData``), on the synthetic corpus
of tests/test_data.py.

Tolerances: ids, text, lengths, speaker stats and batch order exactly.
On a harmonic signal over a noise floor, the resampler and the formant
shift (the recipe's augmentation) within 1e-5; the phase-vocoder
transforms (stretch, pitch, duration) within 1e-4 of the signal's peak:
their phase accumulates in float32 to some 4e4 radians, where one unit in
the last place is 4e-3 radians of a bin's phase. Augmented items and
batches of the corpus's noise-free tones within 1e-4 of their peak: the
spectral nulls between a pure tone's harmonics are rounding noise in both
FFTs, and the envelope estimate smooths that into every bin.
``test_float32_gap_is_rounding`` is the witness for both looser bounds:
run in float64, the two frameworks agree to 1e-9 of the peak, and in
float32 they lie no further apart than each lies from the float64
result."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.data import wave_transforms as jax_wt
from radmmm_tpu.data.dataset import TextOnlyData as JaxTextOnlyData
from radmmm_tpu.data.loader import DataLoader as JaxDataLoader
from radmmm_tpu.data.module import AudioDataModule as JaxDataModule
from radmmm_torch.data import wave_transforms as wt
from radmmm_torch.data.dataset import TextOnlyData
from radmmm_torch.data.loader import DataLoader, stack_raw_batches
from radmmm_torch.data.module import AudioDataModule
from tests.test_data import corpus  # noqa: F401  (module fixture)
from tests.test_data import tone
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO_ATOL = 1e-5
VOCODER_RTOL = 1e-4
ITEM_AUDIO_RTOL = 1e-4
# the recipe's augmentation (radmmm_opensource_data_phonemizerless.yaml),
# drawn more often so that every item meets both scales
AUG = dict(aug_types=["none", "scale_formant", "scale_formant"],
           aug_scales=[1.0, 0.9, 1.1], aug_probabilities=[0.2, 0.4, 0.4],
           aug_languages_applicable=["en_US", "es_ES"], num_aug_in_batch=1,
           randomize_transform=False)


def _signal(sr=16000, dur=0.7):
    t = np.arange(int(sr * dur)) / sr
    x = (0.4 * np.sin(2 * np.pi * 150 * t) + 0.2 * np.sin(2 * np.pi * 300 * t)
         + 0.01 * np.random.default_rng(0).standard_normal(t.size))
    return x.astype(np.float32)[None]


def _corpus_tone():
    """The first utterance of the corpus of tests/test_data.py, as its
    int16 wav is read back."""
    wav = (tone(150, dur=0.4) * 32767 / 0.6).astype(np.int16)
    return (wav / 32768.0).astype(np.float32)[None]


@pytest.mark.parametrize("ratio", (0.9, 1.1))
@pytest.mark.parametrize("name,out_len,tol", (
    ("resample_linear", lambda T, r: T, AUDIO_ATOL),
    ("formant_shift", lambda T, r: T, AUDIO_ATOL),
    ("phase_vocoder_stretch", lambda T, r: int(T / r), VOCODER_RTOL),
    ("pitch_shift", lambda T, r: T, VOCODER_RTOL),
    ("duration_scale", lambda T, r: int(T * r), VOCODER_RTOL)))
def test_wave_transform_matches_jax(name, out_len, tol, ratio):
    x = _signal()
    n = out_len(x.shape[1], ratio)
    want = np.asarray(getattr(jax_wt, name)(jnp.asarray(x), ratio, n))
    got = getattr(wt, name)(torch.from_numpy(x), ratio, n).numpy()
    assert got.shape == want.shape == (1, n)
    scale = 1.0 if tol == AUDIO_ATOL else np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("ratio", (0.9, 1.1))
@pytest.mark.parametrize("name,out_len,signal", (
    ("resample_linear", lambda T, r: T, "noisy"),
    ("formant_shift", lambda T, r: T, "noisy"),
    ("formant_shift", lambda T, r: T, "corpus"),
    ("phase_vocoder_stretch", lambda T, r: int(T / r), "noisy"),
    ("pitch_shift", lambda T, r: T, "noisy"),
    ("duration_scale", lambda T, r: int(T * r), "noisy")))
def test_float32_gap_is_rounding(name, out_len, signal, ratio):
    """Each transform in float64 on both sides (the JAX package under
    ``jax.enable_x64``) and in float32: the float64 results agree to 1e-9
    of the peak, so the two implementations compute one function, and
    the float32 gap between them is at most twice the larger of the two
    float32 errors against the float64 result, so it is their rounding.
    The corpus case is the first utterance of the corpus (a 150 Hz tone
    in int16), where the augmented items differ most."""
    x = _signal() if signal == "noisy" else _corpus_tone()
    n = out_len(x.shape[1], ratio)
    fn, jax_fn = getattr(wt, name), getattr(jax_wt, name)
    want32 = np.asarray(jax_fn(jnp.asarray(x), ratio, n))
    got32 = fn(torch.from_numpy(x), ratio, n).numpy()
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        want64 = np.asarray(jax_fn(jnp.asarray(x64), ratio, n))
    got64 = fn(torch.from_numpy(x64), ratio, n).numpy()
    assert want64.dtype == got64.dtype == np.float64
    peak = np.abs(want64).max()

    def err(a, b):
        return float(np.abs(a - b).max() / peak)

    gap32, gap64 = err(got32, want32), err(got64, want64)
    own = max(err(want32, want64), err(got32, want64))
    print(f"{name} ratio {ratio} {signal} signal: of the peak, float32 gap "
          f"{gap32:.3e}, float64 gap {gap64:.3e}, JAX float32 error "
          f"{err(want32, want64):.3e}, port float32 error "
          f"{err(got32, want64):.3e}")
    assert gap64 <= 1e-9
    assert gap32 <= 2 * own


def test_augmentation_decisions_match_jax():
    port = wt.WaveAugmentations.from_config(AUG)
    ref = jax_wt.WaveAugmentations.from_config(AUG)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for lang in ("en_US", "es_ES", "de_DE") * 20:
        assert port.sample(r1, lang) == ref.sample(r2, lang)
    assert port.max_duration_factor() == ref.max_duration_factor()
    assert port.remap_speaker_id(1, 2, 3) == ref.remap_speaker_id(1, 2, 3)


def _modules(corpus, **kw):  # noqa: F811
    root, datasets, phonemizer_cfg = corpus
    args = dict(train_config=datasets, val_config=datasets, batch_size=2,
                cleaner_names=["basic_cleaners"], g2p_type="phonemizer",
                phonemizer_cfg=phonemizer_cfg,
                dataset_kwargs=dict(
                    speaker_stats_path=str(root / "stats.json"),
                    dur_min=0.1, dur_max=10.2, use_wave_augmentations=True,
                    wave_aug_config=AUG, **kw),
                featurizer_kwargs=dict(mel_fmax=8000.0), num_threads=1,
                seed=3)
    port, ref = AudioDataModule(**args, device="cpu"), JaxDataModule(**args)
    port.setup("fit")
    ref.setup("fit")
    return port, ref


def _same(got, want, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if k == "audio":
            w = np.asarray(w)
            np.testing.assert_allclose(
                np.asarray(g), w, rtol=0,
                atol=ITEM_AUDIO_RTOL * np.abs(w).max(),
                err_msg=f"{what} {k}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            assert g == w, f"{what} {k}"


def test_dataset_items_match_jax(corpus):  # noqa: F811
    """Two epochs of items from one seed: the same augmentation draws and
    speaker remaps, the same audio, text ids and stats."""
    port, ref = _modules(corpus)
    ds, jds = port.trainset, ref.trainset
    assert (ds.speaker_ids, ds.accent_ids) == (jds.speaker_ids,
                                               jds.accent_ids)
    assert port.n_text_tokens == ref.n_text_tokens
    ids = set()
    for _ in range(2):
        for i in range(len(jds)):
            got, want = ds[i], jds[i]
            _same(got, want, f"item {i}")
            ids.add(want["speaker_id"])
    assert len(ids) > len(ds.speaker_ids)       # augmented ids were drawn
    for i in range(len(ref.valset)):
        _same(port.valset[i], ref.valset[i], f"val item {i}")


@pytest.mark.parametrize("shape_runs", (0, 2))
def test_loader_batches_match_jax(corpus, shape_runs):  # noqa: F811
    """Host batches (no featurizer), key by key and in order, two epochs,
    one loader thread."""
    port, ref = _modules(corpus)
    kw = dict(batch_size=2, shuffle=True, featurizer=None, num_threads=1,
              seed=7, hop_length=256, shape_runs=shape_runs)
    loader = DataLoader(port.trainset, **kw)
    jloader = JaxDataLoader(ref.trainset, process_index=0, process_count=1,
                            **kw)
    for epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same(g, w, f"epoch {epoch} batch")
    raws = [port.featurizer.raw_arrays(b) for b in got]
    if raws[0]["audio_i16"].shape == raws[1]["audio_i16"].shape:
        stacked = stack_raw_batches(raws)
        assert stacked["audio_i16"].shape[0] == 2


def test_val_loader_batches_match_jax(corpus):  # noqa: F811
    port, ref = _modules(corpus)
    got = list(DataLoader(port.valset, 2, shuffle=False, num_threads=1))
    want = list(JaxDataLoader(ref.valset, 2, shuffle=False, num_threads=1,
                              process_index=0, process_count=1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w, "val batch")


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "model_inputs", "*.json"))), ids=os.path.basename)
def test_text_only_items_match_jax(path, tmp_path):
    """The shipped inference transcripts with the recipe's text settings
    and speaker stats; the id maps cover every speaker they name."""
    from radmmm_tpu.text.processing import TextProcessing as JaxTP
    from radmmm_torch.text.processing import TextProcessing
    with open(path) as f:
        prompts = json.load(f)
    names = sorted({p[k] for p in prompts for k in p if k.endswith("spk_id")})
    langs = sorted({p["language"] for p in prompts})
    empty = tmp_path / "empty.tsv"
    empty.write_text("")
    tp_args = ("radmmm_phonemizer_marker_segregated", ["radtts_cleaners"])
    tp_kw = dict(g2p_type="phonemizer", prepend_space_to_text=True,
                 append_space_to_text=True, handle_phoneme_ambiguous="first",
                 phonemizer_cfg={lang: str(empty) for lang in langs})
    stats = os.path.join(ROOT, "datasets", "speaker_stats",
                         "opensource_collated_stats.json")
    maps = ({n: i for i, n in enumerate(names)},
            {n: i for i, n in enumerate(langs)})
    port = TextOnlyData(path, TextProcessing(*tp_args, **tp_kw), *maps,
                        speaker_stats_path=stats, f0_pred_type="norm_log_f0")
    ref = JaxTextOnlyData(path, JaxTP(*tp_args, **tp_kw), *maps,
                          speaker_stats_path=stats,
                          f0_pred_type="norm_log_f0")
    assert len(port) == len(ref) == len(prompts)
    for i in range(len(ref)):
        _same(port[i], ref[i], f"prompt {i}")


def test_a_stopped_consumer_waits_no_longer_than_its_limit(monkeypatch):
    """A consumer that stops early waits at most JOIN_TIMEOUT_S for the
    producer to end, then raises with the producer's stack; no wait of the
    loader is without end."""
    import threading
    import time

    from radmmm_torch.data import loader as loader_mod
    monkeypatch.setattr(loader_mod, "JOIN_TIMEOUT_S", 0.5)
    release = threading.Event()

    def stuck_producer(put):
        put(1)
        release.wait(60)      # ignores the consumer's stop

    gen = loader_mod._threaded(stuck_producer, 1)
    assert next(gen) == 1
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not end") as err:
        gen.close()
    assert time.monotonic() - t0 < 10
    assert "stuck_producer" in str(err.value)
    release.set()


def test_a_generator_closed_on_its_producer_thread_does_not_wait():
    """The garbage collector may finalise an abandoned loader generator on
    any thread, its own producer's among them: closing it there neither
    waits for nor joins the thread that runs the close."""
    import threading

    from radmmm_torch.data import loader as loader_mod
    taken, done, errors = threading.Event(), threading.Event(), []
    box = {}

    def producer(put):
        put(1)
        taken.wait(10)
        try:
            box["gen"].close()          # on this, the producer's thread
        except BaseException as e:      # noqa: BLE001 (reported below)
            errors.append(e)
        done.set()

    box["gen"] = loader_mod._threaded(producer, 1)
    assert next(box["gen"]) == 1
    taken.set()
    assert done.wait(10) and not errors
