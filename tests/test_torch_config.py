"""radmmm_torch's config layer against the JAX package's: loading, dotted
overrides and the reference-config translation of every shipped config
and of every tracked config stack, the dataset-recipe expansion, the
speaker-stats collation, and the port's ``build_all`` on the shipped
7-language recipe, whose model config is ``default_radmmm_config()``.
Dicts are held equal exactly."""
import dataclasses
import glob
import os

import pytest
import yaml

from radmmm_tpu.data import recipes as jax_recipes
from radmmm_tpu.utils import config as jax_config
from radmmm_torch.data import recipes
from radmmm_torch.models.tts import default_radmmm_config
from radmmm_torch.training.cli import build_all
from radmmm_torch.utils import config
from tests.test_configs import TRACKED
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
RECIPES = sorted(glob.glob(os.path.join(ROOT, "datasets", "*.json")))
OVERRIDES = ["--model.learning_rate=5e-4", "--trainer.max_steps=7",
             "--data.batch_size=3", "--model.decoder.init_args.n_flows=2",
             "--trainer.profile_dir=/tmp/x", "--model.output_directory=out"]


def _translated(mod, cfg):
    return (mod.translate_reference_model_config(cfg),
            mod.translate_reference_data_config(cfg))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_each_config_loads_and_translates_as_jax(path):
    cfg = config.load_configs([path])
    with open(path) as f:
        assert cfg == (yaml.safe_load(f) or {})
    assert cfg == jax_config.load_configs([path])
    assert _translated(config, cfg) == _translated(jax_config, cfg)


@pytest.mark.parametrize("name", list(TRACKED))
def test_tracked_stacks_translate_as_jax(name, monkeypatch):
    monkeypatch.chdir(ROOT)           # recipe paths in configs are relative
    cfg = config.load_configs(TRACKED[name])
    assert cfg == jax_config.load_configs(TRACKED[name])
    cfg = config.apply_overrides(cfg, OVERRIDES)
    assert cfg == jax_config.apply_overrides(
        jax_config.load_configs(TRACKED[name]), OVERRIDES)
    assert _translated(config, cfg) == _translated(jax_config, cfg)


@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_recipe_expansions_match_jax(path):
    for split in ("train", "val", "all"):
        for root in (None, "/data/audio"):
            assert recipes.recipe_dataset_configs(
                path, split, audio_root=root) == \
                jax_recipes.recipe_dataset_configs(path, split,
                                                   audio_root=root)
    cfg = {"data": {"dataset_recipe": path,
                    "dataset_recipe_audio_root": "/data/audio"}}
    assert config.translate_reference_data_config(cfg) == \
        jax_config.translate_reference_data_config(cfg)


def test_speaker_stats_collation_matches_jax(tmp_path):
    stats_dir = os.path.join(ROOT, "datasets", "speaker_stats")
    got = recipes.collate_speaker_stats(stats_dir, str(tmp_path / "a.json"))
    assert got == jax_recipes.collate_speaker_stats(stats_dir)
    assert (tmp_path / "a.json").exists() and got


def test_build_all_builds_the_7language_recipe(tmp_path, monkeypatch):
    """Tracked config (3): the recipe's TTSConfig is the port's flagship
    config with n_text_tokens from the symbol table, and the trainer and
    data module take the recipe's settings."""
    monkeypatch.chdir(ROOT)
    cfg = config.load_configs(TRACKED["radmmm_multilingual_7lang"])
    cfg["model"]["output_directory"] = str(tmp_path)
    dm, trainer = build_all(cfg, device="cpu")
    assert dm.n_text_tokens == 439
    got = dataclasses.asdict(trainer.tts_config)
    want = dataclasses.asdict(default_radmmm_config(n_text_tokens=439))
    assert got == want
    c = trainer.cfg
    assert (c.megastep_k, c.sampling_rate, c.hop_length, c.seed,
            c.learning_rate, c.grad_clip_val, c.device) == \
        (8, 16000, 256, 42, 1e-4, 1.0, "cpu")
    assert dm.batch_size == 8 and dm.featurizer.sampling_rate == 16000
    loss = trainer.loss_cfg
    assert (loss.kl_loss_start_iter, loss.binarization_start_iter,
            loss.cross_covariance_weight) == (25000, 20000, 1.0)


@pytest.mark.parametrize("name", list(TRACKED))
def test_every_tracked_stack_builds_a_port_model(name, tmp_path,
                                                 monkeypatch):
    """Each tracked stack's TTSConfig builds a port TTSModel (on the meta
    device: shapes only) whose every tensor has the name and shape the
    JAX model's leaf maps to (``jax.eval_shape`` of its init): stack (2)
    with its LSTMConvDAP duration predictor."""
    import functools

    import jax
    import numpy as np
    import torch

    from radmmm_tpu.models.tts import TTSConfig as JaxTTSConfig
    from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
    from radmmm_torch.convert import _flatten, _tts_leaf
    from radmmm_torch.models.attributes import LSTMConvDAP
    from radmmm_torch.models.tts import TTSModel
    from tests.test_tts_model import tiny_batch

    monkeypatch.chdir(ROOT)
    cfg = config.load_configs(TRACKED[name])
    cfg["model"]["output_directory"] = str(tmp_path)
    _, trainer = build_all(cfg, device="cpu")
    with torch.device("meta"):
        port = TTSModel(trainer.tts_config)
    if name == "ljs22_attribute_stack":
        assert isinstance(port.duration_predictor, LSTMConvDAP)
    jm = JaxTTSModel(config=JaxTTSConfig(
        **dataclasses.asdict(trainer.tts_config)))
    batch = {k: np.asarray(a) for k, a in tiny_batch(
        np.random.default_rng(0)).items()}
    batch["mel"] = np.zeros((2, 16, trainer.tts_config.n_mel_channels),
                            np.float32)
    shapes = jax.eval_shape(
        functools.partial(jm.init, binarize=False, train=True),
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    want = {}
    for col, tree in shapes.items():
        views = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
        for path, a in _flatten(views):
            key, a = _tts_leaf(col, path, a)
            want[".".join(key)] = tuple(a.shape)
    got = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert got == want
