"""radmmm_torch's trainer against the JAX package's, through both CLIs'
``build_all`` on a tiny synthetic corpus (the tiny model of
tests/test_end_to_end.py, every dropout rate at 0, mel noise 0): ``fit``
to 6 steps across the binarization (step 3) and KL (step 5) switches,
with validation and checkpoints every 3 steps and groups of 2 steps
(whole groups and the per-step fallback both run), the recipe's formant
augmentation on with one loader thread, so both trainers must draw the
same augmentations in the same order; a resume to step 8; ``predict`` in
both modes; ``export`` loaded by ``serving.load_tts``. The port starts
from the JAX trainer's initial state, carried over by
``convert.load_jax_train_state`` through the ``_init_state`` seam; the
JAX trainer's resume starts from its own fit's last state through the
same seam (the restore overwrites it), which spares it a second trace of
the model's init. The other stacks and launch modes of ``fit`` (tracked
stack (2), the plain and partial loops, ``--distributed``) are in
``tests/test_torch_fit_modes.py``, so the two halves run at once.

Tolerances: every scalar of the two ``metrics.jsonl`` files that draws no
random number (the reconstruction's MCD samples the flow, and steps/s is
a clock) within rtol 1e-4 and atol 1e-4, as the 8-step trajectory of
tests/test_torch_training.py; the quality scalars on fed latents within
1e-4."""
import dataclasses
import functools
import json
import shutil
import os
import time

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from radmmm_tpu.data.dataset import AudioDataset as JaxAudioDataset
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.training import cli as jax_cli
from radmmm_tpu.utils.config import load_configs as jax_load_configs
from radmmm_torch.convert import load_jax_train_state
from radmmm_torch.training import cli as torch_cli
from radmmm_torch.utils.config import load_configs
from radmmm_torch.utils.graphs import Graphed
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-4
# scalars that draw random numbers or read a clock
RANDOM_KEYS = {"train/steps_per_sec", "val/mcd_db"}


def _dap(**kw):
    return {"class_path": "attribute_predictors.ConvLSTMLinearDAP",
            "init_args": dict(n_speaker_dim=4, n_accent_dim=2,
                              use_accent_embedding=True, in_dim=18,
                              out_dim=1, reduction_factor=2,
                              n_backbone_layers=1, n_hidden=8,
                              kernel_size=3, p_dropout=0.0, **kw)}


SR = 22050
# the recipe's augmentation (radmmm_opensource_data_phonemizerless.yaml),
# drawn more often so that both scales and "none" all occur in 6 steps
AUG = {"aug_types": ["none", "scale_formant", "scale_formant"],
       "aug_scales": [1.0, 0.9, 1.1], "aug_probabilities": [0.2, 0.4, 0.4],
       "aug_languages_applicable": ["en_US", "es_ES"],
       "num_aug_in_batch": 1, "randomize_transform": False}


def voiced(f0: float, dur: float, rng) -> np.ndarray:
    """A three-harmonic tone with 5 Hz vibrato over a white-noise floor,
    so every batch's mel covariance is of full rank."""
    t = np.arange(int(SR * dur)) / SR
    phase = 2 * np.pi * f0 * t + 0.3 * np.sin(2 * np.pi * 5.0 * t)
    x = (0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
         + 0.1 * np.sin(3 * phase) + 0.02 * rng.standard_normal(t.size))
    return (x * 32767 / 0.8).astype(np.int16)


def write_corpus(root):
    """Eight utterances of one padded shape, two speakers in two
    languages, in the reference's filelist format, with G2P dictionaries
    and speaker stats. Four batches an epoch: more than the JAX trainer's
    first loader holds when it is left open (its queue of two, the batch
    taken and one more), so a trainer that draws a different number of
    first batches draws other augmentations for its steps."""
    rng = np.random.default_rng(0)
    (root / "wavs" / str(SR)).mkdir(parents=True)
    rows = {"es_ES": [], "en_US": []}
    for i, (f0, spk, text, lang) in enumerate((
            (150, "spk_a", "hola mundo", "es_ES"),
            (220, "spk_a", "buenos dias", "es_ES"),
            (180, "spk_b", "hello world", "en_US"),
            (260, "spk_b", "good morning", "en_US"),
            (170, "spk_a", "mundo hola", "es_ES"),
            (240, "spk_a", "dias buenos", "es_ES"),
            (200, "spk_b", "world hello", "en_US"),
            (280, "spk_b", "morning good", "en_US"))):
        dur = 0.4 + 0.04 * i
        wavfile.write(root / "wavs" / str(SR) / f"utt{i}.wav", SR,
                      voiced(f0, dur, rng))
        rows[lang].append(f"utt{i}.wav|{text}|{spk}|neutral|{dur:.2f}")
    datasets, g2p = {}, {}
    for lang, words in (("es_ES", "hola\tˈola\nmundo\tˈmundo\n"
                                  "buenos\tˈbwenos\ndias\tˈdias\n"),
                        ("en_US", "hello\thəˈloʊ\nworld\twɜrld\n"
                                  "good\tɡʊd\nmorning\tˈmɔrnɪŋ\n")):
        (root / f"train_{lang}.txt").write_text("\n".join(rows[lang]))
        (root / f"{lang}.tsv").write_text(words, encoding="utf-8")
        g2p[lang] = str(root / f"{lang}.tsv")
        datasets[lang] = {"basedir": str(root / "wavs"), "sampling_rate": SR,
                          "filelist_basedir": str(root),
                          "filelist": f"train_{lang}.txt", "language": lang}
    stats = {s: {"log_f0_mean": 5.0, "log_f0_std": 0.3, "f0_mean": 150.0,
                 "f0_std": 40.0, "energy_mean": 0.5, "energy_std": 0.1}
             for s in ("spk_a", "spk_b")}
    (root / "stats.json").write_text(json.dumps(stats))
    return datasets, g2p


@pytest.fixture(scope="module")
def cfg_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    root = out / "corpus"
    datasets, phonemizer_cfg = write_corpus(root)
    model = {
        "use_accent": True, "n_augmentations": 2, "n_speakers": 2,
        "n_accents": 2, "n_accent_dim": 2, "n_speaker_dim": 4,
        "n_text_dim": 16, "use_accent_emb_for_encoder": True,
        "use_speaker_emb_for_alignment": True, "n_mel_channels": 8,
        "decoder": {"class_path": "decoders.RADMMMFlow", "init_args": {
            "use_accent": True, "n_accent_dim": 2, "n_speaker_dim": 4,
            "n_text_dim": 18, "use_context_lstm": True, "n_f0_dims": 1,
            "n_energy_avg_dims": 1, "n_mel_channels": 8, "n_flows": 2,
            "n_conv_layers_per_step": 1, "n_early_size": 2,
            "n_early_every": 2, "n_group_size": 2,
            "affine_model": "wavenet", "scaling_fn": "tanh",
            "use_partial_padding": True}},
        "decoder_loss": {"class_path": "loss.RADMMMLoss", "init_args": {
            "sigma": 1.0, "n_group_size": 2, "kl_loss_start_iter": 4,
            "binarization_loss_weight": 1.0, "ctc_loss_weight": 0.1}},
        "f0_predictor": _dap(target_offset=-5),
        "duration_predictor": _dap(log_target=True),
        "energy_predictor": _dap(target_offset=-0.75),
        "voiced_predictor": _dap(),
        "optim_algo": "RAdam", "learning_rate": 1.0e-3,
        "binarization_start_iter": 3, "iters_per_checkpoint": 3,
        "output_directory": str(out / "unused"),
    }
    data = {"init_args": {
        "batchsize": 2,
        "trainset_config": {"datasets": datasets},
        "valset_config": {"datasets": datasets},
        "sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
        "win_length": 1024, "n_mel_channels": 8, "mel_fmax": 8000.0,
        "f0_min": 80.0, "f0_max": 640.0, "use_log_f0": 1,
        "use_scaled_energy": 1,
        "symbol_set": "radmmm_phonemizer_marker_segregated",
        "cleaners": ["basic_cleaners"], "g2p_type": "phonemizer",
        "phonemizer_cfg": phonemizer_cfg, "dur_min": 0.1, "dur_max": 10.2,
        "speaker_stats_path": str(root / "stats.json"),
        "use_wave_augmentations": True, "wave_aug_config": AUG,
        "num_workers": 1}}
    trainer = {"max_steps": 6, "val_check_interval": 3, "log_interval": 1,
               "n_data": 1, "n_model": 1,
               "megastep_k": 2, "griffin_lim_iters": 2,
               "gradient_clip_val": 1.0, "max_infer_frames": 128,
               "save_code_snapshot": False}
    prompts = out / "prompts.json"
    path = out / "tiny.yaml"
    path.write_text(yaml.safe_dump({"model": model, "data": data,
                                    "trainer": trainer}))
    prompts.write_text(json.dumps([
        {"script": "hola mundo", "spk_id": "spk_a", "emotion": "neutral",
         "language": "es_ES"},
        {"script": "good morning", "spk_id": "spk_b", "emotion": "neutral",
         "language": "en_US"}]))
    yield str(path), str(prompts), out
    shutil.rmtree(out, ignore_errors=True)     # runs and checkpoints


def _no_encoder_dropout(cfg):
    # the configs carry no encoder dropout rate: set it on the built config
    return dataclasses.replace(cfg, encoder_p_dropout=0.0)


class _PortTrainerFromJax(torch_cli.Trainer):
    """The port's trainer, started from a JAX trainer's initial state."""
    jax_state = None

    def _init_state(self, sample_batch):
        state = super()._init_state(sample_batch)
        if self.jax_state is not None:
            load_jax_train_state(state, self.jax_state)
        return state


_graphed_call = Graphed.__call__


def _spy(names: list):
    """``Graphed.__call__`` that records each call's graph name (on the
    CPU, ``Graphed`` then calls its function eagerly)."""
    def call(self, inputs, key=()):
        names.append(self.name)
        return _graphed_call(self, inputs, key)
    return call


def _rows(outdir):
    with open(os.path.join(outdir, "tb", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and set(g) == set(w), (g, w)
        for k in set(w) - RANDOM_KEYS - {"step"}:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {w['step']}: {k}")


_getitem = JaxAudioDataset.__getitem__


def _counted_getitem(self, i):
    item = _getitem(self, i)
    self.n_loaded = getattr(self, "n_loaded", 0) + 1
    return item


def _first_loader_done(dm, timeout=120.0):
    """Wait until the JAX trainer's first loader, left open in its thread
    after the first batch, has loaded the epoch's four batches (its queue
    of two, the batch taken and the one it then holds). The trainer builds
    its state meanwhile, which takes longer in every run of the recipe;
    in this tiny test the wait keeps that order, so the next loader's
    augmentation draws never interleave with the first loader's."""
    deadline = time.monotonic() + timeout
    while getattr(dm.trainset, "n_loaded", 0) < len(dm.trainset):
        assert time.monotonic() < deadline, "the first loader stalled"
        time.sleep(0.01)


@pytest.fixture(scope="module")
def runs(cfg_files):
    """fit to 6, then a resume to 8, on both trainers."""
    path, prompts, out = cfg_files
    jcfg = jax_load_configs([path])
    jcfg["model"]["output_directory"] = str(out / "jax")
    jdm, jtr = jax_cli.build_all(jcfg)
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
        jstate6 = jtr.fit(jdm)
        jtr._init_state = lambda batch: _first_loader_done(jdm) or jstate6
        jtr.cfg.max_steps = 8
        jstate = jtr.fit(jdm)
    jtr._init_state = lambda batch: jstate6     # predict restores over it

    cfg = load_configs([path])
    cfg["model"]["output_directory"] = str(out / "torch")
    dm, tr = torch_cli.build_all(cfg, device="cpu")
    tr.__class__ = _PortTrainerFromJax
    tr.tts_config = _no_encoder_dropout(tr.tts_config)
    tr.jax_state = captured["state"]
    graphed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Graphed, "__call__", _spy(graphed))
        state = tr.fit(dm)
        stats6 = dict(tr.stats)
        tr.jax_state = None              # a resume restores the port's own
        tr.cfg.max_steps = 8
        state = tr.fit(dm)
    return dict(jax=(jdm, jtr), torch=(dm, tr), state=state, stats6=stats6,
                jstate=jstate, prompts=prompts, out=out, graphed=graphed)


def test_fit_and_resume_trajectories_match_jax(runs):
    out = runs["out"]
    got, want = _rows(out / "torch"), _rows(out / "jax")
    assert [r["step"] for r in want] == [2, 3, 3, 3, 4, 5, 6, 6, 6, 8], \
        [r["step"] for r in want]
    _rows_close(got, want)
    assert {"val/f0_rmse", "val/voicing_f1", "val/mcd_db"} <= set(got[3])
    _, tr = runs["torch"]
    assert runs["stats6"]["steps"] == 6 and tr.stats["steps"] == 2
    assert tr.ckpt.steps() == [3, 6, 8] and runs["state"].step == 8


def test_every_fit_step_runs_through_the_graphed_step(runs):
    """The trajectory above went through the graphed steps: every training
    step of the fit and the resume, in whole groups of 2 (steps 1-2 and
    7-8) and in groups that straddle the binarization (step 3) and KL
    (step 5) switches, through the one graphed step, every batch of the
    two validations (4 batches each) through the graphed validation step,
    each validation's samples (the binarized eval forward and
    ``reconstruct``) through their programs, and every batch the loaders
    featurize (each fit's first batch and the three after it, every
    validation batch) through the featurizer's program."""
    graphed = runs["graphed"]
    assert graphed.count("train_step") == 8
    assert graphed.count("val_step") == 2 * 4
    assert graphed.count("val_forward") == graphed.count("reconstruct") == 2
    assert graphed.count("featurize") == 2 * 4 + 2 * 4
    assert set(graphed) == {"train_step", "val_step", "val_forward",
                            "reconstruct", "featurize"}
    assert runs["stats6"]["megastep_steps"] == 2
    assert runs["torch"][1].stats["megastep_steps"] == 2


def test_predict_writes_the_wavs_jax_writes(runs):
    (jdm, jtr), (dm, tr) = runs["jax"], runs["torch"]
    lengths = {}
    for name, dm_, tr_ in (("jax", jdm, jtr), ("torch", dm, tr)):
        dm_.inference_transcript = runs["prompts"]
        tr_.cfg.prediction_output_dir = str(runs["out"] / f"pred_{name}")
        paths = tr_.predict(dm_)
        assert len(paths) == 2
        lengths[name] = []
        for p in paths:
            sr, wav = wavfile.read(p)
            assert sr == 22050
            lengths[name].append(wav.size)
    assert lengths["torch"] == lengths["jax"]


def test_validation_synthesizes_the_fixed_prompts(runs):
    """With ``val_prompts_path`` each validation also synthesizes the
    prompts through the same ``infer`` as ``predict`` and logs their audio
    and mel images."""
    dm, tr = runs["torch"]
    tr.cfg.val_prompts_path = runs["prompts"]
    logged = []
    tr.logger.audio = lambda tag, wav, *a: logged.append((tag, len(wav)))
    tr.logger.image = lambda tag, img, *a: logged.append((tag, img.shape))
    tr._log_tts_samples(runs["state"], dm, 9)
    tags = [t for t, _ in logged]
    assert tags == ["val/tts_sample_0", "val/tts_mel_0",
                    "val/tts_sample_1", "val/tts_mel_1"]
    assert all(n > 0 for t, n in logged if "sample" in t)


def test_predict_reconstruction_writes_the_wavs_jax_writes(runs):
    """Analysis-synthesis of every training utterance: one wav each, of
    its MAS durations' frames, as the JAX package writes."""
    (jdm, jtr), (dm, tr) = runs["jax"], runs["torch"]
    sizes = {}
    for name, dm_, tr_ in (("jax", jdm, jtr), ("torch", dm, tr)):
        tr_.cfg.prediction_output_dir = str(runs["out"] / f"rec_{name}")
        paths = tr_.predict_reconstruction(dm_)
        sizes[name] = {os.path.basename(p): wavfile.read(p)[1].size
                       for p in paths}
    assert len(sizes["jax"]) == 8 and sizes["torch"] == sizes["jax"]


def test_export_loads_with_serving(runs):
    from radmmm_torch.serving import load_tts
    _, tr = runs["torch"]
    path = str(runs["out"] / "tts_export.bin")
    assert tr.export(path, batch_size=2, max_text=32) > 0
    tts = load_tts(path, device="cpu")
    mel, lens = tts(np.ones((1, 12), np.int32), np.asarray([12], np.int32),
                    np.asarray([0], np.int32), np.asarray([1], np.int32),
                    np.asarray([5.0], np.float32),
                    np.asarray([0.3], np.float32), 0)
    assert np.isfinite(np.asarray(mel)).all() and int(lens[0]) > 0


def _with_vocoder(tr, checkpoint, config=None):
    """``tr`` configured with a vocoder checkpoint, its cached vocoder
    dropped; restore with the returned function."""
    old = (tr.cfg.vocoder_checkpoint_path, tr.cfg.vocoder_config_path)
    tr.cfg.vocoder_checkpoint_path, tr.cfg.vocoder_config_path = \
        checkpoint, config
    tr.__dict__.pop("_vocoder", None)

    def restore():
        tr.cfg.vocoder_checkpoint_path, tr.cfg.vocoder_config_path = old
        tr.__dict__.pop("_vocoder", None)
    return restore


def test_predict_vocodes_with_a_vocoder_fit_run(runs, tmp_path):
    """A port ``vocoder-fit`` run dir as the vocoder: ``predict`` writes
    HiFi-GAN audio through its Denoiser, of the lengths JAX writes."""
    from radmmm_torch.utils.checkpoint import CheckpointManager
    from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
    from radmmm_torch.vocoder.utils import GriffinLimVocoder
    dm, tr = runs["torch"]
    run = tmp_path / "voc"
    cfg = HiFiGANConfig(upsample_rates=(8, 8, 4),
                        upsample_kernel_sizes=(16, 16, 8),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1,),), n_mel_channels=8)
    gen = Generator(cfg)
    with torch.no_grad():        # audible through the int16 wav
        gen.conv_post_bias.fill_(0.3)
    CheckpointManager(str(run / "ckpt")).save_payload(
        5, {"step": 5, "gen": gen.state_dict()})
    (run / "generator_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg)))
    restore = _with_vocoder(tr, str(run))
    try:
        dm.inference_transcript = runs["prompts"]
        tr.cfg.prediction_output_dir = str(runs["out"] / "pred_voc")
        paths = tr.predict(dm)
        voc_fn, denoiser = tr._vocoder
        assert not isinstance(voc_fn, GriffinLimVocoder)
        assert denoiser is not None
        frames = tr.predicted_frames
        for p, n in zip(paths, frames):
            sr, wav = wavfile.read(p)
            assert wav.size == n * 256 and np.abs(wav).max() > 0
    finally:
        restore()


def test_export_bakes_a_g_file_in(runs, tmp_path):
    """An upstream ``g_*`` file is baked into the artifact: its requests
    answer with int16 audio, the quantised vocoding of what the mel-only
    artifact answers."""
    from radmmm_torch.serving import load_tts
    from radmmm_torch.vocoder.hifigan import (Generator, HiFiGANConfig,
                                              upstream_generator_state_dict)
    _, tr = runs["torch"]
    cfg = HiFiGANConfig(upsample_rates=(8, 8, 4),
                        upsample_kernel_sizes=(16, 16, 8),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1,),), n_mel_channels=8)
    torch.manual_seed(3)
    gen = Generator(cfg).eval()
    g_path = tmp_path / "g_00000003"
    torch.save({"generator": upstream_generator_state_dict(gen)}, g_path)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({
        "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
        "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1]], "num_mels": 8}))
    request = (np.ones((1, 12), np.int32), np.asarray([12], np.int32),
               np.asarray([0], np.int32), np.asarray([1], np.int32),
               np.asarray([5.0], np.float32),
               np.asarray([0.3], np.float32), 0)
    mel_path, audio_path = (str(tmp_path / f"{k}.bin")
                            for k in ("mel", "audio"))
    tr.export(mel_path, batch_size=2, max_text=32, use_vocoder=False)
    restore = _with_vocoder(tr, str(g_path), str(cfg_path))
    try:
        tr.export(audio_path, batch_size=2, max_text=32)
    finally:
        restore()
    mel, lens = load_tts(mel_path, device="cpu")(*request)
    tts = load_tts(audio_path, device="cpu")
    audio, alens = tts(*request)
    assert tts.output_kind == "audio" and audio.dtype == torch.int16
    assert int(alens[0]) == int(lens[0]) > 0
    with torch.no_grad():
        want = torch.round(gen(mel).clamp(-1, 1) * 32767).to(torch.int16)
    assert audio.shape == want.shape
    assert int((audio.int() - want.int()).abs().max()) <= 1


def test_quality_scalars_match_jax_on_fed_latents(runs):
    """The validation quality row after the resumed fits, each trainer on
    its own first validation batch, the reconstruction at sigma 0."""
    from radmmm_tpu.training.step import device_batch
    from radmmm_tpu.utils.quality import reconstruction_quality as jax_q
    from radmmm_torch.utils.quality import reconstruction_quality
    (jdm, jtr), (dm, tr) = runs["jax"], runs["torch"]
    jb = device_batch(next(iter(jdm.val_dataloader())))
    variables = runs["jstate"].model_variables()
    jout = jax.jit(functools.partial(
        jtr.model.apply, binarize=True, train=False, mutable=False))(
            variables, jb)
    jrec = jax.jit(functools.partial(
        jtr.model.apply, sigma=0.0, method=JaxTTSModel.reconstruct))(
            variables, jax.random.key(0), jb)
    want = jax_q(jax.tree_util.tree_map(np.asarray, jb),
                 np.asarray(jrec["mel"]), jout)
    batch = next(iter(dm.val_dataloader()))
    with torch.no_grad():
        out = tr.model(batch, binarize=True, train=False)
        rec = tr.model.reconstruct(batch, sigma=0.0)
    got = reconstruction_quality(
        {k: v.numpy() for k, v in batch.items()
         if isinstance(v, torch.Tensor)}, rec["mel"].numpy(),
        {k: {n: t.numpy() for n, t in v.items()} for k, v in out.items()
         if isinstance(v, dict)})
    assert set(got) == set(want) == {"mcd_db", "f0_rmse", "voicing_f1"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
