"""radmmm_torch vocoder training against the JAX package: ``random_segments``
on the same numpy seed, ``HiFiGANTrainer`` over 3 GAN steps from one
state carried across by ``convert.load_jax_vocoder_state``, and the
``vocoder-fit`` CLI on a tiny corpus (fit to 3 steps, then a resume to 5,
whose ``metrics.jsonl`` rows match the JAX package's resume from the same
step-3 state). The discriminators are at the JAX package's fixed widths
(32 to 1024 channels); the generator is small (rates 8, 8, 4; 32
channels), the segments 2,048 samples, batch 2. The trainer test blurs
the generator's input (``BLUR``: every step, by one kernel, so both
frameworks' different draws blur alike); the port's trainers step on its
own ``Optimizer`` (Adam in optax's order).

Tolerances: segments bit for bit, their mels within 1e-5 of the largest
magnitude; each step's losses within rtol 1e-4 (the discriminators' Adam
steps move the generator's loss through the updated discriminators) and
every parameter after 3 AdamW steps within 3e-5, 5% of the 6e-4 that
three steps at lr 2e-4 can move it (AdamW moves an element whose
gradient is below its eps of 1e-8 by about g / eps, so the f32 rounding
of such a gradient, summed in another order, shows in its update almost
in full; measured: 1.25e-5 at worst, in 11 of 8,192 elements), with at
most 0.5% of each tensor's elements beyond 1e-6; the CLI's logged losses after the resume
within rtol 1e-4 (steps/s is a clock and not compared)."""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from radmmm_tpu.data.module import AudioDataModule as JaxAudioDataModule
from radmmm_tpu.ops.stft import MelSpectrogram as JaxMelSpectrogram
from radmmm_tpu.training import vocoder_loop as jvl
from radmmm_tpu.training import vocoder_train as jvt
from radmmm_tpu.utils.config import (
    translate_reference_data_config as jax_translate)
from radmmm_tpu.vocoder import hifigan as jh
from radmmm_torch.convert import (discriminator_state_dict_from_jax,
                                  hifigan_state_dict_from_jax,
                                  load_jax_vocoder_state)
from radmmm_torch.ops.stft import MelSpectrogram
from radmmm_torch.training import cli as torch_cli
from radmmm_torch.training import vocoder_train as tvt
from radmmm_torch.utils.checkpoint import CheckpointManager
from radmmm_torch.vocoder.hifigan import HiFiGANConfig
from radmmm_torch.vocoder.utils import get_vocoder
from tests.test_torch_convert import perturb
from tests.test_torch_fit import write_corpus
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-4
PARAM_ATOL = 3e-5
GEN = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), n_mel_channels=80)
SEGMENT = 2048
# the CLI's VocoderTrainConfig: the featurizer's rate, FFT, hop and mel
# channels, and the vocoder section's train keys
TRAIN = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
             n_mel_channels=80, segment_size=SEGMENT)


def _audio(rng, lens):
    audio = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = 0.3 * np.sin(np.arange(n) * (0.05 + 0.01 * i)) \
            + 0.02 * rng.standard_normal(n)
    return audio, np.asarray(lens, np.int32)


def test_random_segments_match_jax(rng):
    """Starts from the same numpy generator, rounded down to the hop;
    short items zero-padded; mels trimmed to segment // hop frames."""
    audio, lens = _audio(rng, [9000, 3000, 1500])
    want = jvt.random_segments(audio, lens,
                               JaxMelSpectrogram(1024, 256, 1024, 80, 22050,
                                                 0.0, None),
                               SEGMENT, np.random.default_rng(7))
    got = tvt.random_segments(audio, lens,
                              MelSpectrogram(1024, 256, 1024, 80, 22050, 0.0,
                                             None),
                              SEGMENT, np.random.default_rng(7), "cpu")
    np.testing.assert_array_equal(got["audio"].numpy(),
                                  np.asarray(want["audio"]))
    assert got["mel"].shape == want["mel"].shape == (3, 8, 80)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               rtol=0, atol=1e-5 * np.abs(
                                   np.asarray(want["mel"])).max())
    assert not got["audio"][2, 1500:].any()


# blur_p 1 and one sigma: the blurred branch at every step, one kernel
BLUR = dict(blur_p=1.0, blur_sigmas=(1.0,))


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    return jvt.HiFiGANTrainer(jh.HiFiGANConfig(**GEN),
                              jvt.VocoderTrainConfig(**TRAIN, **BLUR))


def test_hifigan_trainer_matches_jax_over_3_steps(rng):
    """Both trainers from one perturbed JAX state (optimizer moments at
    zero), the generator's input blurred: each step's five losses, and
    every parameter of the generator and both discriminators after 3
    steps."""
    jtr = _jax_trainer()
    audio, lens = _audio(rng, [6000, 5000])
    batch = jvt.random_segments(audio, lens, jtr.mel_loss_fn, SEGMENT,
                                np.random.default_rng(0))
    state = jtr.init_state(jax.random.key(0), batch)
    moved = {k: perturb({"params": getattr(state, k)}, seed=i)["params"]
             for i, k in enumerate(("gen_params", "mpd_params",
                                    "msd_params"))}
    state = dataclasses.replace(
        state, **moved, gen_opt=jtr.gen_tx.init(moved["gen_params"]),
        disc_opt=jtr.disc_tx.init({"mpd": moved["mpd_params"],
                                   "msd": moved["msd_params"]}))
    port = tvt.HiFiGANTrainer(HiFiGANConfig(**GEN),
                              tvt.VocoderTrainConfig(**TRAIN, **BLUR),
                              device="cpu")
    load_jax_vocoder_state(port, jax.tree_util.tree_map(np.asarray, state))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for step in range(3):
        state, want = jtr.train_step(state, batch)
        got = port.train_step(tbatch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, err_msg=f"{step}: {k}")
    assert port.step == int(state.step) == 3
    host = jax.tree_util.tree_map(np.asarray, state)
    for module, sd in (
            (port.gen, hifigan_state_dict_from_jax(
                {"params": host.gen_params})),
            (port.mpd, discriminator_state_dict_from_jax(
                {"params": host.mpd_params})),
            (port.msd, discriminator_state_dict_from_jax(
                {"params": host.msd_params}))):
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), sd[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=name)
            off = np.abs(p.detach().numpy() - sd[name].numpy()) > 1e-6
            assert off.mean() <= 5e-3, (name, int(off.sum()))


def test_gan_step_leaves_no_gradient_in_the_discriminators(rng):
    """After a step (the generator's input blurred), the discriminators'
    gradients are those of the D loss alone, taken at their weights
    before the step: the generator's backward adds nothing to them."""
    import copy
    from radmmm_torch.vocoder import hifigan as th
    port = tvt.HiFiGANTrainer(HiFiGANConfig(**GEN),
                              tvt.VocoderTrainConfig(**TRAIN, blur_p=1.0),
                              device="cpu")
    audio, lens = _audio(rng, [3000, 3000])
    batch = tvt.random_segments(audio, lens, port.mel_loss_fn, SEGMENT,
                                np.random.default_rng(0), "cpu")
    gen, mpd, msd = (copy.deepcopy(m) for m in (port.gen, port.mpd,
                                                 port.msd))
    port.train_step(batch)
    mel = th.gaussian_blur_augment(batch["mel"], th.blur_generator(0, 0),
                                   port.blur_kernels, 1.0)
    with torch.no_grad():
        y_hat = gen(mel)
    pr, pg, _, _ = mpd(batch["audio"], y_hat)
    sr, sg, _, _ = msd(batch["audio"], y_hat)
    (th.discriminator_loss(pr, pg) + th.discriminator_loss(sr, sg)).backward()
    for want_m, got_m in ((mpd, port.mpd), (msd, port.msd)):
        for (name, w), g in zip(want_m.named_parameters(),
                                got_m.parameters()):
            torch.testing.assert_close(g.grad, w.grad, rtol=1e-5,
                                       atol=1e-9, msg=name)
    assert all(p.grad is not None for p in port.gen.parameters())


def _write_configs(tmp_path, out_dir, vocoder):
    root = tmp_path / "corpus"
    datasets, g2p = write_corpus(root)
    data = {"data": {"init_args": {
        "batchsize": 2, "trainset_config": {"datasets": datasets},
        "sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
        "win_length": 1024, "n_mel_channels": 80, "mel_fmax": 8000.0,
        "symbol_set": "radmmm_phonemizer_marker_segregated",
        "cleaners": ["basic_cleaners"], "g2p_type": "phonemizer",
        "phonemizer_cfg": g2p, "dur_min": 0.1, "dur_max": 10.2,
        "speaker_stats_path": str(root / "stats.json"), "num_workers": 1}}}
    voc = {"vocoder": dict(vocoder, output_directory=str(out_dir),
                           max_steps=3, log_interval=1,
                           iters_per_checkpoint=3)}
    dpath, vpath = tmp_path / "d.yaml", tmp_path / "v.yaml"
    dpath.write_text(yaml.safe_dump(data))
    vpath.write_text(yaml.safe_dump(voc))
    return ["-c", str(dpath), "-c", str(vpath)]


def _rows(out_dir):
    with open(os.path.join(out_dir, "tb", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rows_close(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in set(w) - {"step", "vocoder/steps_per_sec"}:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL,
                                       err_msg=f"step {w['step']}: {k}")


HIFIGAN_SECTION = {"generator": {k: [list(x) if isinstance(x, tuple) else x
                                     for x in v] if isinstance(v, tuple)
                                 else v for k, v in GEN.items()},
                   "train": {"segment_size": SEGMENT}}


def test_vocoder_fit_cli_resumes_as_jax_does(tmp_path):
    """The port's CLI fits to 3 (its own init) and saves; its step-3
    checkpoint is then replaced by the JAX run's step-3 state, carried
    across by convert.py, and both resume to 5: the rows of steps 4-5
    agree, as do the step counts and the loader and segment draws that
    restart on a resume. ``get_vocoder(<run dir>)`` then vocodes."""
    from radmmm_tpu.utils.config import load_configs as jax_load_configs
    jax_out, torch_out = tmp_path / "jax", tmp_path / "torch"
    argv = _write_configs(tmp_path, torch_out, HIFIGAN_SECTION)
    cfg_paths = argv[1::2]

    jcfg = jax_load_configs(cfg_paths)
    jcfg["vocoder"]["output_directory"] = str(jax_out)
    jstate3 = jvl.vocoder_fit(
        jcfg, JaxAudioDataModule(**jax_translate(jcfg)))
    jstate3 = jax.tree_util.tree_map(np.asarray, jstate3)
    jcfg["vocoder"]["max_steps"] = 5
    jvl.vocoder_fit(jcfg, JaxAudioDataModule(**jax_translate(jcfg)))

    _, trainer = torch_cli.main(["vocoder-fit"] + argv + ["--device", "cpu"])
    assert trainer.step == 3
    rows = _rows(torch_out)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    with open(torch_out / "generator_config.json") as f:
        assert HiFiGANConfig.from_dict(json.load(f)) == trainer.gen.config
    # the JAX run's step-3 state in the port's format
    port = tvt.HiFiGANTrainer(HiFiGANConfig(**GEN),
                              tvt.VocoderTrainConfig(**TRAIN), device="cpu")
    load_jax_vocoder_state(port, jstate3)
    CheckpointManager(str(torch_out / "ckpt")).save_payload(
        3, port.state_dict())

    _, resumed = torch_cli.main(["vocoder-fit"] + argv + [
        "--device", "cpu", "--vocoder.max_steps=5"])
    assert resumed.step == 5 and resumed.stats["restore_s"] > 0
    assert sorted(os.listdir(torch_out / "ckpt")) == ["3", "5"]
    _rows_close(_rows(torch_out)[3:], _rows(jax_out)[3:])

    fn, den = get_vocoder("hifigan", vocoder_checkpoint_path=str(torch_out),
                          device="cpu")
    mel = torch.randn(2, 6, 80)
    with torch.no_grad():
        want = resumed.gen.eval()(mel)
    torch.testing.assert_close(fn(mel), want, rtol=0, atol=0)
    assert den(want).shape == want.shape


def test_waveglow_vocoder_fit_runs_and_resumes(tmp_path):
    """``vocoder.vocoder_type: waveglow`` trains the flow's NLL, saves,
    resumes to the next step; its run dir is refused by ``get_vocoder``,
    as the JAX package refuses it."""
    out = tmp_path / "wg"
    argv = _write_configs(tmp_path, out, {
        "vocoder_type": "waveglow",
        "generator": {"n_flows": 2, "n_group": 4, "n_early_every": 4,
                      "wn_channels": 8, "wn_layers": 2,
                      "upsample_kernel": 512},
        "train": {"segment_size": 1024}})
    _, tr = torch_cli.main(["vocoder-fit"] + argv + ["--device", "cpu"])
    assert tr.step == 3 and isinstance(tr, tvt.WaveGlowTrainer)
    _, tr2 = torch_cli.main(["vocoder-fit"] + argv + [
        "--device", "cpu", "--vocoder.max_steps=4"])
    rows = _rows(out)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["vocoder/nll"]) for r in rows)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert a.shape == b.shape
    assert not (out / "generator_config.json").exists()
    with pytest.raises(ValueError, match="hifigan runs"):
        get_vocoder("waveglow", vocoder_checkpoint_path=str(out),
                    device="cpu")
