"""The port's copies of the JAX package's last two scripts:
``radmmm_torch/scripts/aug_disentangle_experiment.py`` (its statistics
against the JAX script's, a run at a tiny size on the CPU, the report and
the committed card run's metrics in the JAX run's schema) and
``examples/torch_synthesize.py``.

Tolerances: the evaluation statistics of one model and batch in both
packages 1e-4 (the flow NLL relative, the reconstruction mel-L1
absolute: f32 through the whole model, as test_torch_featurizer.py holds
``reconstruct``); the cross-covariance of the same tables 1e-6 relative
(the same numpy code on float32 tables)."""
import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.training import optim as jax_optim
from radmmm_tpu.training import step as jax_step
from radmmm_torch.scripts import aug_disentangle_experiment as aug
from radmmm_torch.training import step
from tests.test_torch_featurizer import REG, _port
from tests.test_torch_featurizer import featurized  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_METRICS = REPO / "examples" / "aug_experiment" / "metrics.json"
PORT_METRICS = REPO / "examples" / "torch_aug_experiment" / "metrics.json"


def _jax_script():
    """The JAX package's script, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_aug_disentangle_experiment",
        REPO / "scripts" / "aug_disentangle_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_speakers,n_accents,dim", [
    (4, 2, 8), (6, 2, 4), (4, 3, 16)])
def test_cross_cov_matches_the_jax_script(n_speakers, n_accents, dim):
    rng = np.random.default_rng(n_speakers * 10 + dim)
    spk = rng.standard_normal((n_speakers + 2, dim)).astype(np.float32)
    acc = rng.standard_normal((n_accents, dim)).astype(np.float32)
    spk_accent = list(rng.permutation(np.arange(n_speakers) % n_accents))
    want = _jax_script().cross_cov(spk, acc, spk_accent)
    got = aug.cross_cov(spk, acc, spk_accent)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got > 0


def test_evaluation_statistics_match_jax(featurized):
    """One model (dropout off, perturbed weights) and one featurized batch
    in both packages: the JAX script's statistics (make_val_step's
    loss_mel, reconstruct's per-utterance mel-L1, the cross-covariance of
    the embedding tables) against the port's ``evaluate_model``, both
    reconstructing at sigma 0 (the JAX script samples at sigma 1 from its
    own key; the port from its own generator)."""
    jm, v, jbatch, batch = featurized
    script = _jax_script()
    tx = jax_optim.build_optimizer("RAdam", learning_rate=1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats={}, spectral=v["spectral"], opt_state=tx.init(params))
    # the JAX script's evaluate, its loop body on this batch
    m = jax.jit(jax_step.make_val_step(jm, jax_step.LossConfig(**REG)))(
        jstate, jbatch)
    rec = jm.apply(jstate.model_variables(), jax.random.key(0), jbatch, 0.0,
                   method=JaxTTSModel.reconstruct)
    mel_rec, mel_gt = np.asarray(rec["mel"]), np.asarray(jbatch["mel"])
    lens = np.asarray(jbatch["output_lengths"])
    l1 = [float(np.abs(mel_rec[i, :int(L)] - mel_gt[i, :int(L)]).mean())
          for i, L in enumerate(lens)]
    spk_accent = [1, 0, 1]
    want = {"cross_nll": float(m["loss_mel"]),
            "cross_recon_mel_l1": float(np.mean(l1)), "n_cross_utts": 2,
            "emb_cross_cov": script.cross_cov(
                np.asarray(params["speaker_embeddings"]["embedding"]),
                np.asarray(params["accent_embeddings"]["embedding"]),
                spk_accent)}

    port = _port(jm, v).eval()
    state = step.create_train_state(port, device="cpu")
    got = aug.evaluate_model(
        port, step.make_val_step(port, step.LossConfig(**REG)), state,
        [batch], spk_accent, sigma=0.0)
    assert got["n_cross_utts"] == want["n_cross_utts"]
    np.testing.assert_allclose(got["cross_nll"], want["cross_nll"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["cross_recon_mel_l1"],
                               want["cross_recon_mel_l1"], atol=1e-4)
    np.testing.assert_allclose(got["emb_cross_cov"], want["emb_cross_cov"],
                               rtol=1e-6)
    # the per-utterance L1 of the port's helper on the JAX arrays
    np.testing.assert_allclose(aug.recon_l1(mel_rec, mel_gt, lens), l1,
                               rtol=0)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The experiment at a tiny size on the CPU: the corpus's minimal
    model, ``--n-train 8 --n-val 2``, 2 steps a fit with megastep_k 2."""
    work = tmp_path_factory.mktemp("aug")
    meta = aug.main(["--steps", "2", "--workdir", str(work / "work"),
                     "--outdir", str(work / "out"), "--n-train", "8",
                     "--n-val", "2", "--device", "cpu", "--tiny",
                     "--trainer.megastep_k=2"])
    yield meta, work
    shutil.rmtree(work, ignore_errors=True)    # two runs and their corpus


def _schema(meta: dict) -> dict:
    return {"top": {k: type(v) for k, v in meta.items() if k != "results"},
            "arms": sorted(meta["results"]),
            "results": {k: type(v) for k, v in
                        meta["results"]["no_aug"].items()}}


def test_tiny_run_writes_the_jax_runs_schema(tiny_run):
    meta, work = tiny_run
    with open(JAX_METRICS) as f:
        want = _schema(json.load(f))
    with open(work / "out" / "metrics.json") as f:
        got = _schema(json.load(f))
    assert want["top"].items() <= got["top"].items()
    assert got["arms"] == want["arms"] == ["aug", "no_aug"]
    for arm in ("aug", "no_aug"):
        res = meta["results"][arm]
        assert res["ckpt_step"] == 2 and res["n_cross_utts"] == 8
        assert all(np.isfinite(res[k]) for k in (
            "cross_nll", "cross_recon_mel_l1", "emb_cross_cov"))
        assert {k: type(res[k]) for k in want["results"]} == \
            want["results"]
    assert meta["device"]["card"] == "the CPU (no card)"
    assert {s["steps"] for s in meta["fit_stats"].values()} == {2}
    text = (work / "out" / "REPORT.md").read_text()
    assert "| decoder flow NLL (cross) |" in text and "JAX aug ON" in text


def test_report_says_where_the_sign_differs_from_jax():
    with open(JAX_METRICS) as f:
        jax_meta = json.load(f)
    res = {arm: dict(r) for arm, r in jax_meta["results"].items()}
    meta = {"steps": 1200, "n_train": 64, "n_val": 16,
            "device": {"card": "a card", "torch": "x", "cuda": "y"},
            "results": res}
    assert "the way it did in the JAX" in aug.report(meta, jax_meta)
    res["aug"]["cross_nll"] = res["no_aug"]["cross_nll"] + 1.0
    text = aug.report(meta, jax_meta)
    assert "does not have the JAX package's sign" in text
    assert "ROADMAP Queue 3" in text


def test_committed_card_run_has_the_jax_runs_schema():
    """examples/torch_aug_experiment/metrics.json: the card run at the
    JAX run's 1,200 steps, in its schema, with the card beside it."""
    with open(JAX_METRICS) as f:
        jax_meta = json.load(f)
    with open(PORT_METRICS) as f:
        meta = json.load(f)
    want, got = _schema(jax_meta), _schema(meta)
    assert want["top"].items() <= got["top"].items()
    assert got["arms"] == want["arms"] and got["results"] == want["results"]
    assert meta["steps"] == jax_meta["steps"] == 1200
    assert meta["n_train"] == jax_meta["n_train"]
    assert "H100" in meta["device"]["card"]
    for arm in ("aug", "no_aug"):
        assert meta["results"][arm]["ckpt_step"] == 1200
        assert meta["results"][arm]["n_cross_utts"] == \
            jax_meta["results"][arm]["n_cross_utts"]
    assert (PORT_METRICS.parent / "REPORT.md").exists()


def test_synthesize_example_writes_the_prompts(tiny_run, tmp_path):
    """examples/torch_synthesize.py on the tiny run: build_all, the run's
    checkpoint, trainer.predict on a prompts file, one wav a prompt."""
    _, work = tiny_run
    spec = importlib.util.spec_from_file_location(
        "torch_synthesize", REPO / "examples" / "torch_synthesize.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps([
        {"script": "kela masi tuno", "spk_id": "spk_a",
         "emotion": "neutral", "language": "en_US"},
        {"script": "soma nile lato", "spk_id": "spk_c",
         "emotion": "neutral", "language": "en_UK"}]))
    corpus = work / "work" / "corpus"
    paths = mod.main(["-c", str(corpus / "model.yaml"),
                      "-c", str(corpus / "data.yaml"),
                      "--prompts", str(prompts), "--out",
                      str(tmp_path / "wavs"), "--sigma", "0.5",
                      "--max-frames", "64",
                      "--ckpt_path", str(work / "work" / "run_no_aug"),
                      "--device", "cpu"])
    assert len(paths) == 2 and all(os.path.getsize(p) > 44 for p in paths)
