"""radmmm_torch weight bridge and package hygiene.

Also holds the helpers the other ``test_torch_*`` files share: the tiny
JAX TTSModel, a perturbation of its zero-initialised leaves (so couplings
and biases are not identities) and the port model built from it.
"""
import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.vocoder.hifigan import (Generator as JaxGenerator,
                                        HiFiGANConfig as JaxHiFiGANConfig)
from radmmm_torch.convert import (hifigan_state_dict_from_jax,
                                  tts_state_dict_from_jax)
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tests.test_tts_model import tiny_batch, tiny_config

REPO = Path(__file__).resolve().parents[1]
SMALL_VOCODER = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                     upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3), (1, 3)),
                     n_mel_channels=8)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(variables, seed=0):
    """numpy copy of flax variables with every float param (and the
    whitening mean) moved by a small seeded amount, so zero-initialised
    leaves (WN ``end`` convs, biases) are not zero. The LU diagonals are
    left alone: a sign flip there would make W near singular."""
    rng = np.random.default_rng(seed)
    out = to_numpy(variables)

    def move(path, a):
        name = path[-1].key
        if a.dtype != np.float32 or name in ("upper_diag", "p"):
            return a
        std = float(a.std()) if a.size > 1 else 0.0
        scale = 0.05 * std if std > 0 else 1e-3
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    moved = {"params": jax.tree_util.tree_map_with_path(move, out["params"])}
    if "buffers" in out:
        moved["buffers"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32) if p[-1].key == "input_mean" else a,
            out["buffers"])
    for col in out:
        moved.setdefault(col, out[col])
    return moved


@functools.lru_cache(maxsize=None)
def jax_tiny_tts(seed=0):
    """(flax TTSModel, perturbed numpy variables) at tests' tiny config."""
    model = JaxTTSModel(config=tiny_config())
    variables = jax.jit(
        functools.partial(model.init, binarize=False, train=True))(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            tiny_batch(np.random.default_rng(0)))
    return model, perturb(variables, seed)


def torch_tts(jax_model, variables) -> TTSModel:
    port = TTSModel(TTSConfig(**dataclasses.asdict(jax_model.config)))
    port.load_state_dict(tts_state_dict_from_jax(variables))
    return port.eval().cache_inverses()


@functools.lru_cache(maxsize=None)
def jax_small_vocoder(resblock="1"):
    gen = JaxGenerator(config=JaxHiFiGANConfig(resblock=resblock,
                                               **SMALL_VOCODER))
    variables = jax.jit(gen.init)(jax.random.key(7), jnp.zeros((1, 16, 8)))
    return gen, perturb(variables, seed=7)


def torch_vocoder(variables, resblock="1") -> Generator:
    port = Generator(HiFiGANConfig(resblock=resblock, **SMALL_VOCODER))
    port.load_state_dict(hifigan_state_dict_from_jax(variables))
    return port.eval()


def _n_leaves(variables, collections):
    return sum(len(jax.tree_util.tree_leaves(variables[c]))
               for c in collections if c in variables)


def test_tts_every_leaf_maps_to_one_port_tensor():
    jm, variables = jax_tiny_tts()
    assert set(variables) == {"params", "buffers", "spectral"}
    sd = tts_state_dict_from_jax(variables)
    assert len(sd) == _n_leaves(variables, variables)
    want = TTSModel(TTSConfig(**dataclasses.asdict(jm.config))).state_dict()
    assert set(sd) == set(want), (set(sd) ^ set(want))
    for k, v in sd.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k


def test_tts_layout_rules():
    """Spot checks of the layout rules on known leaves."""
    _, variables = jax_tiny_tts()
    sd = tts_state_dict_from_jax(variables)
    p = variables["params"]
    v = p["text_encoder"]["conv_0"]["v"]                  # (K, Cin, Cout)
    np.testing.assert_array_equal(sd["text_encoder.conv_0.v"].numpy(),
                                  v.transpose(2, 1, 0))
    k = p["duration_predictor"]["backbone"]["dense"]["kernel"]
    np.testing.assert_array_equal(
        sd["duration_predictor.backbone.dense.weight"].numpy(), k.T)
    end = p["decoder"]["flow_1"]["coupling"]["wn"]["end"]["kernel"]
    np.testing.assert_array_equal(
        sd["decoder.flows.1.coupling.wn.end.weight"].numpy(),
        end.transpose(2, 1, 0))
    u = variables["spectral"]["text_encoder"]["lstm"][
        "SpectralNormedParam_1"]["wh_bwd_u"]
    np.testing.assert_array_equal(sd["text_encoder.lstm.sn_bwd.u"].numpy(), u)
    np.testing.assert_array_equal(
        sd["text_embeddings.weight"].numpy(),
        p["text_embeddings"]["embedding"])
    assert sd["decoder.flows.0.invtbl_conv.initialized"].dtype == torch.bool


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_every_leaf_maps_to_one_port_tensor(resblock):
    _, variables = jax_small_vocoder(resblock)
    sd = hifigan_state_dict_from_jax(variables)
    assert len(sd) == _n_leaves(variables, ["params"])
    want = Generator(HiFiGANConfig(resblock=resblock,
                                   **SMALL_VOCODER)).state_dict()
    assert set(sd) == set(want), (set(sd) ^ set(want))
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    # the upsampling ConvTranspose keeps g per input channel
    p = variables["params"]
    assert sd["up_0_v"].shape == p["up_0_v"].transpose(1, 2, 0).shape
    assert sd["up_0_g"].shape == (p["up_0_v"].shape[1],)


def test_unknown_collection_is_refused():
    _, variables = jax_tiny_tts()
    with pytest.raises(ValueError, match="batch_stats"):
        tts_state_dict_from_jax({**variables, "batch_stats": {}})


def test_port_imports_no_jax():
    """Importing every radmmm_torch module leaves jax and flax out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import radmmm_torch\n"
        "for m in pkgutil.walk_packages(radmmm_torch.__path__, "
        "'radmmm_torch.'):\n"
        "    if m.name != 'radmmm_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'radmmm_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_import_check_walks_the_vocoder_slice():
    """The modules of the vocoder slice are among those the import check
    above walks."""
    import pkgutil
    import radmmm_torch
    walked = {m.name for m in pkgutil.walk_packages(radmmm_torch.__path__,
                                                    "radmmm_torch.")}
    assert {"radmmm_torch.vocoder.hifigan", "radmmm_torch.vocoder.waveglow",
            "radmmm_torch.vocoder.utils",
            "radmmm_torch.training.vocoder_train",
            "radmmm_torch.training.vocoder_loop",
            "radmmm_torch.utils.profiling"} <= walked


def test_port_sources_import_nothing_from_the_jax_package():
    """No Python source under radmmm_torch/ imports radmmm_tpu (docstrings
    name its files only as the counterparts)."""
    offenders = []
    for path in (REPO / "radmmm_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and node.value.startswith(("radmmm_tpu", "jax", "flax"))):
                names = [node.value]
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in ("radmmm_tpu", "jax",
                                                 "flax")]
    assert not offenders, offenders
