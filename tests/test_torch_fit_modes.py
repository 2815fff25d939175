"""The stacks and launch modes of radmmm_torch's ``fit`` beside the
recipe's trainer of ``tests/test_torch_fit.py`` (its helpers and its
``cfg_files`` corpus): tracked stack (2)'s shape (an LSTMConvDAP duration
predictor, speaker-only frame predictors, no accent in the encoder) runs
``fit`` to 4 steps on the same corpus through both trainers; the plain
(``megastep_k`` 1) and partial-group loops through the graphed steps;
``fit --distributed`` over two gloo processes in torchrun's environment
(the invariants of tests/test_multihost.py: identical parameters, finite
losses, logging on rank 0 only, one checkpoint, a resume that goes on);
the CLI's device switch, the logger's files and Griffin-Lim.

Tolerances: stack (2)'s ``metrics.jsonl`` scalars as the recipe's (rtol
1e-4 and atol 1e-4); Griffin-Lim with a fed initial phase within 1e-4 of
the signal's peak."""
import json

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
from radmmm_torch.training import cli as torch_cli
from radmmm_torch.utils.config import load_configs
from radmmm_torch.utils.graphs import Graphed
from tests.test_torch_fit import (_PortTrainerFromJax, _counted_getitem,
                                  _dap, _first_loader_done,
                                  _no_encoder_dropout, _rows, _rows_close,
                                  _spy)
from tests.test_torch_fit import cfg_files  # noqa: F401 (a fixture)
from tests.test_torch_parallel import ROOT, _free_port, run_ranks
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _lstm_conv_dap(**kw):
    return {"class_path": "attribute_predictors.LSTMConvDAP",
            "init_args": dict(n_speaker_dim=4, in_dim=16, out_dim=1,
                              reduction_factor=2, n_backbone_layers=2,
                              n_hidden=8, kernel_size=3, p_dropout=0.0,
                              **kw)}


def _frame_dap(**kw):
    """A frame predictor of tracked stack (2): speaker-only, no accent."""
    d = _dap(**kw)
    d["init_args"].update(n_accent_dim=0, use_accent_embedding=False,
                          in_dim=16)
    return d


@pytest.fixture(scope="module")
def stack2_runs(cfg_files):
    """Tracked stack (2)'s shape at the tiny width (configs/radtts_*.yaml:
    no accent in the encoder or the alignment keys, the decoder's accent
    embedding on, speaker-only frame predictors and an LSTMConvDAP
    duration predictor) on the same corpus: fit to 4 steps on both
    trainers, binarization and KL on from the first step (one phase, one
    compile of the JAX step; the phase switches are the recipe test's),
    validation and checkpoints every 2."""
    path, _, out = cfg_files
    with open(path) as f:
        doc = yaml.safe_load(f)
    m = doc["model"]
    m.update(use_accent_emb_for_encoder=False,
             use_speaker_emb_for_alignment=False,
             binarization_start_iter=0, iters_per_checkpoint=2)
    m["decoder"]["init_args"].update(n_text_dim=16,
                                     use_accent_emb_for_decoder=True)
    m["decoder_loss"]["init_args"]["kl_loss_start_iter"] = -1
    m["f0_predictor"] = _frame_dap(target_offset=-5)
    m["energy_predictor"] = _frame_dap(target_offset=-0.75)
    m["voiced_predictor"] = _frame_dap()
    m["duration_predictor"] = _lstm_conv_dap(log_target=True)
    doc["trainer"].update(max_steps=4, val_check_interval=2)
    stack2 = out / "stack2.yaml"
    stack2.write_text(yaml.safe_dump(doc))

    jcfg = jax_load_configs([str(stack2)])
    jcfg["model"]["output_directory"] = str(out / "jax2")
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
        jtr.fit(jdm)

    cfg = load_configs([str(stack2)])
    cfg["model"]["output_directory"] = str(out / "torch2")
    dm, tr = torch_cli.build_all(cfg, device="cpu")
    tr.__class__ = _PortTrainerFromJax
    tr.tts_config = _no_encoder_dropout(tr.tts_config)
    tr.jax_state = captured["state"]
    state = tr.fit(dm)
    return dict(out=out, trainer=tr, state=state)


def test_stack2_fit_matches_jax(stack2_runs):
    """Tracked stack (2)'s shape: the port's metrics.jsonl rows equal
    JAX's, every logged loss finite (the duration loss of the LSTMConvDAP
    among them)."""
    from radmmm_torch.models.attributes import LSTMConvDAP
    out, tr = stack2_runs["out"], stack2_runs["trainer"]
    assert isinstance(tr.model.duration_predictor, LSTMConvDAP)
    got, want = _rows(out / "torch2"), _rows(out / "jax2")
    assert [r["step"] for r in want] == [2, 2, 2, 4, 4, 4], \
        [r["step"] for r in want]
    _rows_close(got, want)
    assert any("train/duration_loss" in r for r in got)
    assert all(np.isfinite(v) for r in got for k, v in r.items()
               if "loss" in k)
    assert tr.ckpt.steps() == [2, 4] and stack2_runs["state"].step == 4


@pytest.mark.parametrize("megastep_k", [1, 3])
def test_plain_and_partial_fits_run_through_the_graphed_step(
        cfg_files, tmp_path, megastep_k):
    """The port's fit alone to 4 steps, validating at step 4: with
    megastep_k 1 (the plain loop over the loader's featurized batches) or
    3 (a whole group of 3, then a partial group of the epoch's fourth
    batch), every step goes through the graphed step, every validation
    batch through the graphed validation step and the validation's
    samples through their programs, and every batch the loaders
    featurize through the featurizer's program (from their threads, so
    counted apart: the first batch's four, the batches the JAX package's
    first loader fills its queue with, validation's four and, at
    megastep_k 1, the training loader's four); one row a step (a whole
    group's last step only), every logged value finite."""
    path, _, _ = cfg_files
    cfg = load_configs([path])
    cfg["model"]["output_directory"] = str(tmp_path / "run")
    cfg["trainer"].update(megastep_k=megastep_k, max_steps=4,
                          val_check_interval=4)
    dm, tr = torch_cli.build_all(cfg, device="cpu")
    graphed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Graphed, "__call__", _spy(graphed))
        tr.fit(dm)
    assert [n for n in graphed if n != "featurize"] == (
        ["train_step"] * 4 + ["val_step"] * 4 + ["val_forward", "reconstruct"])
    assert graphed.count("featurize") == (12 if megastep_k == 1 else 8)
    s = tr.stats
    assert s["steps"] == 4 and s["graphed_steps"] == 0     # the CPU: eager
    assert s["megastep_steps"] == (3 if megastep_k == 3 else 0)
    rows = _rows(tmp_path / "run")
    assert [r["step"] for r in rows if "train/loss" in r] == (
        [3, 4] if megastep_k == 3 else [1, 2, 3, 4])
    assert [r["step"] for r in rows if "val/loss" in r] == [4]
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "step"), r


def test_griffin_lim_with_a_fed_phase_matches_jax():
    from radmmm_tpu.vocoder.utils import GriffinLimVocoder as JaxGL
    from radmmm_torch.vocoder.utils import GriffinLimVocoder
    mel = np.random.default_rng(3).uniform(-8, 0, (2, 20, 80)).astype(
        np.float32)
    want = np.asarray(JaxGL(n_iters=30)(jax.numpy.asarray(mel),
                                        jax.random.key(1)))
    # the JAX vocoder's initial phase, drawn as griffin_lim draws it
    phase = np.array(jax.random.uniform(
        jax.random.key(1), (2, 20, 513), minval=-np.pi, maxval=np.pi))
    got = GriffinLimVocoder(n_iters=30)(torch.from_numpy(mel),
                                        phase=torch.from_numpy(phase))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_cli_needs_a_card_unless_asked_for_the_cpu(cfg_files):
    path, _, out = cfg_files
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for sub in ("fit", "vocoder-fit"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_cli.main([sub, "-c", path,
                            f"--model.output_directory={out / 'nocard'}"])
    # --distributed reads torchrun's environment and says how to launch
    with pytest.raises(RuntimeError, match="torchrun"):
        torch_cli.main(["fit", "-c", path, "--distributed",
                        "--device", "cpu"])


def test_logger_writes_metrics_images_and_audio(tmp_path):
    """metrics.jsonl rows, PNG files of the three plots (8-bit RGB, the
    arrays' shapes upscaled) and 16-bit wavs under step_N/."""
    import zlib
    from radmmm_torch.utils.logging import (TrainLogger,
                                            plot_alignment_to_numpy,
                                            plot_curves_to_numpy,
                                            plot_mel_to_numpy)
    log = TrainLogger(str(tmp_path / "tb"), artifact_dir=str(tmp_path / "a"))
    log.scalars("val", {"loss": 1.5, "name": "skipped"}, 7)
    rng = np.random.default_rng(0)
    images = {"val/attention": plot_alignment_to_numpy(rng.random((40, 9))),
              "val/mel": plot_mel_to_numpy(rng.random((30, 80))),
              "val/curves": plot_curves_to_numpy(
                  {"f0_gt": rng.random(50), "f0_pred": rng.random(50)})}
    for tag, img in images.items():
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
        log.image(tag, img, 7)
    log.audio("val/wav", 2.0 * np.sin(np.arange(800) / 5.0), 7, 16000)
    log.flush()
    assert _rows(tmp_path) == [{"step": 7, "val/loss": 1.5}]
    step_dir = tmp_path / "a" / "step_0000007"
    for tag, img in images.items():
        blob = (step_dir / (tag.replace("/", "_") + ".png")).read_bytes()
        assert blob[:8] == b"\x89PNG\r\n\x1a\n"
        w, h = int.from_bytes(blob[16:20], "big"), int.from_bytes(
            blob[20:24], "big")
        assert (h, w) == img.shape[:2]
        idat = blob.index(b"IDAT")
        n = int.from_bytes(blob[idat - 4:idat], "big")
        raw = zlib.decompress(blob[idat + 4:idat + 4 + n])
        assert len(raw) == h * (1 + 3 * w)
    sr, wav = wavfile.read(step_dir / "val_wav.wav")
    assert sr == 16000 and wav.dtype == np.int16 and wav.size == 800
    assert np.abs(wav).max() == 32767          # peak-normalised from 2.0


FIT_CHILD = r"""
import hashlib, json, os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from radmmm_torch.training import cli
dm, trainer = cli.main(sys.argv[1:])
blob = b"".join(trainer.mesh.gather_param(n, p).detach().numpy().tobytes()
                for n, p in trainer.model.named_parameters())
rank = int(os.environ["RANK"])
with open(os.path.join(os.environ["RESULT_DIR"], f"rank{{rank}}.json"),
          "w") as f:
    json.dump(dict(digest=hashlib.sha256(blob).hexdigest(),
                   logger=trainer.logger.enabled, ckpts=trainer.ckpt.steps(),
                   steps=trainer.stats["steps"]), f)
"""


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_distributed_fit_and_resume(cfg_files, tmp_path, n_data, n_model):
    """``fit --distributed --device cpu`` in two processes with torchrun's
    environment, data parallel (n_data 2, batches of 2 a rank: the 8
    utterances make two rounds an epoch) or tensor parallel (n_model 2,
    both ranks the same batches, the WN stacks split), in groups of 2
    steps: fit to 4 steps, validating every 2, then a resume to 6. Both
    ranks end each run with the same (gathered) parameters, only rank 0
    logs (each step once, every loss finite), the first run leaves one
    checkpoint, and the resume starts from it and adds its steps."""
    path, _, _ = cfg_files
    out = tmp_path / "run"
    script = tmp_path / "fit_child.py"
    script.write_text(FIT_CHILD.format(root=ROOT))

    def launch(max_steps, tag):
        res = tmp_path / tag
        res.mkdir()
        port = str(_free_port())
        argv = ["fit", "-c", path, "--device", "cpu", "--distributed",
                f"--model.output_directory={out}",
                f"--trainer.n_data={n_data}", f"--trainer.n_model={n_model}",
                f"--trainer.max_steps={max_steps}",
                "--trainer.val_check_interval=2",
                "--model.iters_per_checkpoint=100"]
        logs = run_ranks(str(script), lambda r: argv, lambda r: dict(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
            RESULT_DIR=str(res)))
        results = [json.loads((res / f"rank{r}.json").read_text())
                   for r in range(2)]
        assert results[0]["digest"] == results[1]["digest"], tag
        assert [r["logger"] for r in results] == [True, False]
        return logs, results

    logs, results = launch(4, "fit")
    assert all(r["ckpts"] == [4] and r["steps"] == 4 for r in results)
    assert (f"training over mesh {{'data': {n_data}, 'model': {n_model}}}"
            in logs[0])
    rows = _rows(out)
    # groups of 2 log once, the group that crosses the binarization switch
    # (step 3) step by step; one writer, so no step twice
    assert [r["step"] for r in rows if "train/loss" in r] == [2, 3, 4]
    assert [r["step"] for r in rows if "val/loss" in r] == [2, 4]
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "step"), r

    logs, results = launch(6, "resume")
    assert "resumed from step 4" in logs[0] and "resumed from step 4" in \
        logs[1]
    assert all(r["ckpts"] == [4, 6] and r["steps"] == 2 for r in results)
    rows = _rows(out)
    assert [r["step"] for r in rows if "train/loss" in r][-2:] == [5, 6]
