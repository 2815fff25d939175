"""radmmm_torch's feature caches against the JAX package's: the F0 cache
(radmmm_torch/data/f0_cache.py), the dataset's audio and F0 caches
(data/dataset.py), the two build scripts (radmmm_torch/scripts/
build_audio_cache.py, build_f0_cache.py) and a cache-fed ``fit``, on
tests/test_torch_fit.py's tiny corpus and config (eight tones with
vibrato over a noise floor, two speakers, formant augmentation, one
loader thread).

Tolerances: ``transform_cached_f0`` exactly; the port's F0 cache against
JAX's (each computed by its own pYIN, both on the CPU) F0 within rtol 1e-5
on voiced frames and p_voiced within 1e-6 (measured 6.0e-7 and 1.2e-7),
voicing equal: no frame of these tones is a Viterbi tie (see
tests/test_torch_featurizer.py::test_f0_matches_jax); the audio caches
byte for byte; a cache-fed batch against the compute path as
tests/test_f0_cache.py holds JAX's; the cache-fed ``fit`` rows at
test_torch_fit.py's rtol 1e-4."""
import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from radmmm_tpu.data.dataset import AudioDataset as JaxAudioDataset
from radmmm_tpu.data.f0_cache import \
    transform_cached_f0 as jax_transform_cached_f0
from radmmm_tpu.data.module import AudioDataModule as JaxAudioDataModule
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.training import cli as jax_cli
from radmmm_tpu.utils.config import load_configs as jax_load_configs
from radmmm_tpu.utils.config import \
    translate_reference_data_config as jax_translate
from radmmm_torch.data.collate import collate_host
from radmmm_torch.data.f0_cache import (build_f0_cache, f0_key,
                                        transform_cached_f0)
from radmmm_torch.data.module import AudioDataModule
from radmmm_torch.native import FeatureCache
from radmmm_torch.scripts import build_audio_cache
from radmmm_torch.scripts import build_f0_cache as build_f0_script
from radmmm_torch.training import cli as torch_cli
from radmmm_torch.utils.config import (load_configs,
                                       translate_reference_data_config)
from tests.test_torch_fit import (_PortTrainerFromJax, _counted_getitem,
                                  _first_loader_done, _no_encoder_dropout,
                                  _rows, _rows_close, cfg_files)  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
F0_RTOL, PVOICED_ATOL = 1e-5, 1e-6


def _run_jax_script(name, argv):
    """``main()`` of the JAX package's scripts/<name>.py, loaded from its
    file, with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name] + argv)
        return mod.main()


@pytest.fixture(scope="module")
def caches(cfg_files):
    """Both packages' F0 and audio caches of the corpus (its training and
    validation sets share their eight utterances), each made by its
    package's build script."""
    path, _, out = cfg_files
    paths = {side: {"f0": str(out / f"{side}_f0"),
                    "audio": str(out / f"{side}_audio")}
             for side in ("port", "jax")}
    n_f0 = build_f0_script.main(["-c", path, "-o", paths["port"]["f0"],
                                 "--batch-size", "4", "--device", "cpu"])
    n_audio = build_audio_cache.main(["-c", path, "-o",
                                      paths["port"]["audio"],
                                      "--device", "cpu"])
    _run_jax_script("build_f0_cache", ["-c", path, "-o", paths["jax"]["f0"],
                                       "--batch-size", "4"])
    _run_jax_script("build_audio_cache",
                    ["-c", path, "-o", paths["jax"]["audio"]])
    assert n_f0 == 8           # the validation set's repeats are skipped
    assert n_audio == 16       # one record a listed line, as JAX writes
    return paths


def _modules(cfg_files, **dataset_kwargs):
    """(port, JAX) data modules of the tiny config, set up for fit, with
    ``dataset_kwargs`` over the config's."""
    dk = translate_reference_data_config(load_configs([cfg_files[0]]))
    jdk = jax_translate(jax_load_configs([cfg_files[0]]))
    dk["dataset_kwargs"].update(dataset_kwargs)
    jdk["dataset_kwargs"].update(dataset_kwargs)
    dm = AudioDataModule(**dk, device="cpu")
    jdm = JaxAudioDataModule(**jdk)
    dm.setup("fit")
    jdm.setup("fit")
    return dm, jdm


TRANSFORMS = {"none": {}, "formant": {"formant": 1.1},
              "pitch": {"pitch": 1.25}, "duration_up": {"duration": 1.5},
              "duration_down": {"duration": 0.77},
              "pitch_and_duration": {"pitch": 0.87, "duration": 1.13},
              "all": {"formant": 0.9, "pitch": 1.1, "duration": 0.93}}


@pytest.mark.parametrize("factors", sorted(TRANSFORMS))
def test_transform_cached_f0_matches_jax(rng, factors):
    track = np.stack([rng.uniform(80, 400, 47), rng.integers(0, 2, 47),
                      rng.uniform(0, 1, 47)]).astype(np.float32)
    got = transform_cached_f0(track, TRANSFORMS[factors])
    want = jax_transform_cached_f0(track, TRANSFORMS[factors])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    d = TRANSFORMS[factors].get("duration", 1.0)
    assert got.shape == (3, max(1, int(round(47 * d))))
    if "pitch" not in TRANSFORMS[factors] and d == 1.0:
        np.testing.assert_array_equal(got, track)


def test_f0_cache_matches_jax(cfg_files, caches):
    """The same keys and lengths; F0, voicing and p_voiced as the module
    docstring bounds them."""
    dm, _ = _modules(cfg_files)
    port = FeatureCache(caches["port"]["f0"])
    jax_c = FeatureCache(caches["jax"]["f0"])
    assert len(port) == len(jax_c) == len(dm.trainset) == 8
    for i in range(len(dm.trainset)):
        item = dm.trainset[i]
        key = f0_key(item["audiopath"])
        got, want = port.get_array(key), jax_c.get_array(key)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (3, 1 + len(item["audio"]) // 256)
        np.testing.assert_array_equal(got[1], want[1], err_msg=key)
        v = want[1] > 0
        assert v.mean() > 0.8, key                   # tones: mostly voiced
        np.testing.assert_allclose(got[0][v], want[0][v], rtol=F0_RTOL)
        assert (got[0][~v] == 0).all() and (want[0][~v] == 0).all()
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=PVOICED_ATOL)


def test_audio_cache_matches_jax_byte_for_byte(caches):
    for ext in (".dat", ".idx"):
        with open(caches["port"]["audio"] + ext, "rb") as f, \
                open(caches["jax"]["audio"] + ext, "rb") as g:
            assert f.read() == g.read(), ext


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_datasets_read_either_cache(cfg_files, caches, writer):
    """With both caches from either package, the port's items equal the
    JAX package's (audio and cached F0 exactly), and the audio equals the
    wav path's."""
    kw = dict(use_wave_augmentations=False,
              audio_cache_path=caches[writer]["audio"],
              f0_cache_path=caches[writer]["f0"])
    dm, jdm = _modules(cfg_files, **kw)
    plain, _ = _modules(cfg_files, use_wave_augmentations=False)
    for i in range(len(dm.trainset)):
        got, want = dm.trainset[i], jdm.trainset[i]
        np.testing.assert_array_equal(got["audio"], want["audio"])
        np.testing.assert_array_equal(got["audio"], plain.trainset[i]["audio"])
        assert got["cached_f0"] is not None
        np.testing.assert_array_equal(got["cached_f0"], want["cached_f0"])
        raw = FeatureCache(caches[writer]["f0"]).get_array(
            f0_key(got["audiopath"]))
        np.testing.assert_array_equal(got["cached_f0"], raw)
        assert plain.trainset[i]["cached_f0"] is None


def test_missing_audio_record_drops_the_item(cfg_files, caches, tmp_path,
                                             capsys):
    from radmmm_torch.native import FeatureCacheWriter
    path = str(tmp_path / "partial")
    with FeatureCacheWriter(path) as w:
        w.put_array("elsewhere.wav", np.zeros(10, np.float32))
    dm, _ = _modules(cfg_files, use_wave_augmentations=False,
                     audio_cache_path=path)
    assert dm.trainset[0] is None
    assert "not in audio cache" in capsys.readouterr().out


def test_cached_batch_matches_compute_path(cfg_files, caches):
    """A cache-fed batch against the compute path: mel and energy within
    1e-6, F0 within 5e-3 (log F0) on >90% of valid frames, voicing equal
    on >90%, padding zero; the track is consumed, not shipped."""
    dm, _ = _modules(cfg_files, use_wave_augmentations=False,
                     f0_cache_path=caches["port"]["f0"])
    plain, _ = _modules(cfg_files, use_wave_augmentations=False)
    idx = range(4)
    host_c = collate_host([dm.trainset[i] for i in idx])
    host_p = collate_host([plain.trainset[i] for i in idx])
    assert "cached_f0" in host_c and "cached_f0" not in host_p
    b_c, b_p = dm.featurizer(host_c), plain.featurizer(host_p)
    assert "cached_f0" not in b_c
    for k in ("mel", "energy_avg"):
        np.testing.assert_allclose(b_c[k].numpy(), b_p[k].numpy(), atol=1e-6)
    lens = b_p["output_lengths"].numpy()
    for i, n in enumerate(lens):
        f0c, f0p = b_c["f0"][i].numpy(), b_p["f0"][i].numpy()
        assert np.isclose(f0c[:n], f0p[:n], atol=5e-3).mean() > 0.9, i
        vc, vp = (b["voiced_mask"][i, :n].numpy() for b in (b_c, b_p))
        assert (vc == vp).mean() > 0.9, i
        assert np.abs(f0c[n:]).max(initial=0) == 0
        assert np.abs(b_c["voiced_mask"][i, n:].numpy()).max(initial=0) == 0


@pytest.mark.parametrize("aug", ["pitch", "duration"])
def test_augmented_items_get_the_transformed_track(cfg_files, caches, aug):
    """Every item augmented by a pitch or duration scale: the port's item
    carries the cached track transformed by its factors, equal to the JAX
    package's item drawn from the same seed."""
    wave = {"aug_probability": 1.0, "n_augmentations": 1,
            "use_formant_scaling": False,
            "use_pitch_scaling": aug == "pitch", "pitch_range": (1.2, 1.2),
            "use_duration_scaling": aug == "duration",
            "duration_range": (1.25, 1.25)}
    dm, jdm = _modules(cfg_files, f0_cache_path=caches["port"]["f0"],
                       use_wave_augmentations=True, wave_aug_config=wave)
    cache = FeatureCache(caches["port"]["f0"])
    for i in range(3):
        got, want = dm.trainset[i], jdm.trainset[i]
        raw = cache.get_array(f0_key(got["audiopath"]))
        np.testing.assert_array_equal(got["cached_f0"], want["cached_f0"])
        if aug == "pitch":
            np.testing.assert_allclose(got["cached_f0"][0], raw[0] * 1.2,
                                       rtol=1e-6)
            np.testing.assert_array_equal(got["cached_f0"][1:], raw[1:])
        else:
            F = raw.shape[1]
            assert got["cached_f0"].shape == (3, int(round(F * 1.25)))
            # the stretched audio's frames cover the stretched track
            assert abs(1 + len(got["audio"]) // 256
                       - got["cached_f0"].shape[1]) <= 2


def test_build_f0_cache_refuses_augmented_datasets(cfg_files, tmp_path):
    dm, _ = _modules(cfg_files)            # the config's augmentation on
    with pytest.raises(ValueError, match="un-augmented"):
        build_f0_cache(dm.trainset, str(tmp_path / "f0"), device="cpu")


@pytest.mark.parametrize("script", ["build_audio_cache", "build_f0_cache"])
def test_scripts_need_a_card_unless_asked_for_the_cpu(cfg_files, tmp_path,
                                                      script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"build_audio_cache": build_audio_cache,
           "build_f0_cache": build_f0_script}[script]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["-c", cfg_files[0], "-o", str(tmp_path / "c")])


def test_f0_cache_without_validation_set(cfg_files, tmp_path):
    """--no-include-val caches the training set only (here the same eight
    utterances), with yin as the config's method."""
    path = tmp_path / "yin.yaml"
    doc = yaml.safe_load(open(cfg_files[0]))
    doc["data"]["init_args"]["f0_method"] = "yin"
    path.write_text(yaml.safe_dump(doc))
    out = str(tmp_path / "f0")
    assert build_f0_script.main(["-c", str(path), "-o", out,
                                 "--no-include-val", "--device",
                                 "cpu"]) == 8
    assert len(FeatureCache(out)) == 8


@pytest.fixture(scope="module")
def cached_fits(cfg_files, caches):
    """fit to 3 steps from each package's own F0 cache, on both trainers,
    the port from the JAX trainer's initial state: binarization and KL on
    from the first step (one phase), a group of 2 steps then one, no
    validation."""
    path, _, out = cfg_files
    doc = yaml.safe_load(open(path))
    doc["model"].update(binarization_start_iter=0,
                        iters_per_checkpoint=100)
    doc["model"]["decoder_loss"]["init_args"]["kl_loss_start_iter"] = -1
    doc["trainer"].update(max_steps=3, val_check_interval=100)
    runs = {}
    for side in ("jax", "port"):
        doc["data"]["init_args"]["f0_cache_path"] = caches[side]["f0"]
        doc["model"]["output_directory"] = str(out / f"cached_{side}")
        cfg_path = out / f"cached_{side}.yaml"
        cfg_path.write_text(yaml.safe_dump(doc))
        runs[side] = str(cfg_path)

    jdm, jtr = jax_cli.build_all(jax_load_configs([runs["jax"]]))
    jtr.model = JaxTTSModel(config=_no_encoder_dropout(jtr.model.config))
    captured = {}
    init = jtr._init_state

    def capture(batch):
        _first_loader_done(jdm)
        state = init(batch)
        captured["state"] = jax.tree_util.tree_map(np.asarray, state)
        return state

    jtr._init_state = capture
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAudioDataset, "__getitem__", _counted_getitem)
        jtr.fit(jdm)

    dm, tr = torch_cli.build_all(load_configs([runs["port"]]), device="cpu")
    tr.__class__ = _PortTrainerFromJax
    tr.tts_config = _no_encoder_dropout(tr.tts_config)
    tr.jax_state = captured["state"]
    fed = []
    real = dm.featurizer._featurize

    def featurize(*a, **kw):
        fed.append(kw.get("cached_f0", a[5] if len(a) > 5 else None)
                   is not None)
        return real(*a, **kw)

    dm.featurizer._featurize = featurize
    state = tr.fit(dm)
    return dict(out=out, dm=dm, jdm=jdm, state=state, fed=fed)


def test_cache_fed_fit_matches_jax(cached_fits):
    out = cached_fits["out"]
    got, want = _rows(out / "cached_port"), _rows(out / "cached_jax")
    assert [r["step"] for r in want] == [2, 3], [r["step"] for r in want]
    _rows_close(got, want)
    assert all(np.isfinite(v) for r in got for k, v in r.items()
               if "loss" in k)
    # every training batch came with its tracks: pYIN never ran
    assert cached_fits["fed"] and all(cached_fits["fed"])
    assert cached_fits["dm"].trainset.f0_cache is not None
    assert cached_fits["state"].step == 3
    assert os.path.isdir(out / "cached_port" / "ckpt" / "3")
