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
from tests.test_torch_threads import one_torch_thread  # noqa: F401

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
    with pytest.raises(ValueError, match="intermediates"):
        tts_state_dict_from_jax({**variables, "intermediates": {}})


def _m12_config(variant):
    """The tiny config with M12's modules: a spline first step with batch
    norms and film_stack affine steps after it, or simple_conv affine
    steps; an LSTMConvDAP duration predictor in both."""
    cfg = tiny_config()
    dur = dict(_class="LSTMConvDAP", n_speaker_dim=4, in_dim=18, out_dim=1,
               reduction_factor=2, n_backbone_layers=2, n_hidden=8,
               kernel_size=3, log_target=True)
    decoder = (dict(cfg.decoder, n_splines=1, use_bn=True,
                    affine_model="film_stack") if variant == "spline_film"
               else dict(cfg.decoder, affine_model="simple_conv"))
    return dataclasses.replace(cfg, decoder=decoder, duration_predictor=dur)


@functools.lru_cache(maxsize=None)
def jax_m12_tts(variant):
    model = JaxTTSModel(config=_m12_config(variant))
    variables = jax.jit(
        functools.partial(model.init, binarize=False, train=True))(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            tiny_batch(np.random.default_rng(0)))
    return model, to_numpy(variables)


@pytest.mark.parametrize("variant", ["spline_film", "simple_conv"])
def test_m12_leaves_each_map_to_one_port_tensor(variant):
    """Every leaf of every collection (batch_stats included) maps to one
    port tensor of its shape, and the new leaves follow the layout
    rules."""
    jm, variables = jax_m12_tts(variant)
    assert ("batch_stats" in variables) == (variant == "spline_film")
    sd = tts_state_dict_from_jax(variables)
    assert len(sd) == _n_leaves(variables, variables)
    want = TTSModel(TTSConfig(**dataclasses.asdict(jm.config))).state_dict()
    assert set(sd) == set(want), (set(sd) ^ set(want))
    for k, v in sd.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
    p = variables["params"]
    dur = p["duration_predictor"]["backbone"]
    np.testing.assert_array_equal(
        sd["duration_predictor.backbone.lstm.wi_fwd"].numpy(),
        dur["lstm"]["wi_fwd"])
    np.testing.assert_array_equal(
        sd["duration_predictor.backbone.conv_1.v"].numpy(),
        dur["conv_1"]["v"].transpose(2, 1, 0))
    if variant == "spline_film":
        film = p["decoder"]["flow_0"]["coupling"]["film"]
        np.testing.assert_array_equal(
            sd["decoder.flows.0.coupling.film.block_0.cond_conv.v"].numpy(),
            film["block_0"]["cond_conv"]["v"].transpose(2, 1, 0))
        np.testing.assert_array_equal(
            sd["decoder.flows.0.coupling.film.end.weight"].numpy(),
            film["end"]["kernel"].transpose(2, 1, 0))
        stats = variables["batch_stats"]["decoder"]["flow_0"]["coupling"][
            "film"]["block_0"]["bn"]
        for k in ("mean", "var"):
            np.testing.assert_array_equal(
                sd[f"decoder.flows.0.coupling.film.block_0.bn.{k}"].numpy(),
                stats[k])
        assert "decoder.flows.1.coupling.film.block_0.hidden_conv.v" in sd
    else:
        scn = p["decoder"]["flow_1"]["coupling"]["scn"]
        np.testing.assert_array_equal(
            sd["decoder.flows.1.coupling.scn.layer_0.weight"].numpy(),
            scn["layer_0"]["kernel"].transpose(2, 1, 0))
        assert "decoder.flows.1.coupling.scn.last.weight" in sd


def _alt_decoders():
    """(name, flax module, its init arguments, port module) of each
    alternative decoder at a small width."""
    from radmmm_tpu.models import alt_decoders as J
    from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
    from radmmm_torch.models import alt_decoders as P
    rng = np.random.default_rng(0)
    ctx = jnp.asarray(rng.standard_normal((2, 16, 12)), jnp.float32)
    spk = jnp.ones((2, 4))
    f0 = jnp.ones((2, 16))
    lens = JaxSeqLens.create(jnp.asarray([16, 9]), 16)
    mel = jnp.zeros((2, 16, 8))
    voc = JaxHiFiGANConfig(**SMALL_VOCODER)
    return [
        ("deterministic",
         J.DeterministicDecoder(n_mel_channels=8, n_speaker_dim=4,
                                n_layers=2, n_channels=16),
         (ctx, spk, lens, f0, f0),
         P.DeterministicDecoder(8, 4, 2, 16, n_context_dim=12)),
        ("e2e",
         J.E2ETTSDecoder(n_mel_channels=8, n_speaker_dim=4, n_layers=1,
                         n_channels=16, vocoder_config=voc),
         (ctx, spk, lens, f0, f0),
         P.E2ETTSDecoder(8, 4, 1, 16, HiFiGANConfig(**SMALL_VOCODER),
                         n_context_dim=12)),
        ("diffusion",
         J.DiffusionDecoder(n_mel_channels=8, n_context_dim=12, n_layers=2,
                            n_channels=16),
         (jax.random.key(1), mel, ctx, lens),
         P.DiffusionDecoder(8, 12, 2, 16))]


@pytest.mark.parametrize("i", range(3), ids=["deterministic", "e2e",
                                             "diffusion"])
def test_alt_decoder_every_leaf_maps_to_one_port_tensor(i):
    from radmmm_torch.convert import alt_decoder_state_dict_from_jax
    _, jm, args, port = _alt_decoders()[i]
    variables = to_numpy(jax.jit(jm.init)(jax.random.key(0), *args))
    sd = alt_decoder_state_dict_from_jax(variables)
    assert len(sd) == _n_leaves(variables, ["params"])
    want = port.state_dict()
    assert set(sd) == set(want), (set(sd) ^ set(want))
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    if i == 2:
        k = variables["params"]["step_embedding"]["Dense_1"]["kernel"]
        np.testing.assert_array_equal(
            sd["step_embedding.Dense_1.weight"].numpy(), k.T)
        assert "net.res_skip_1.v" in sd and "net.cond_0.g" in sd
    with pytest.raises(ValueError, match="batch_stats"):
        alt_decoder_state_dict_from_jax({**variables, "batch_stats": {}})


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


def _jax_imports(path) -> list:
    """The JAX-package, jax and flax modules a Python source imports (or
    names in a string that starts with one, as importlib would take)."""
    offenders = []
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
                      if n.split(".")[0] in ("radmmm_tpu", "jax", "flax")]
    return offenders


def test_port_sources_import_nothing_from_the_jax_package():
    """No Python source under radmmm_torch/ imports radmmm_tpu (docstrings
    name its files only as the counterparts)."""
    offenders = []
    for path in (REPO / "radmmm_torch").rglob("*.py"):
        offenders += _jax_imports(path)
    assert not offenders, offenders


def test_import_check_walks_the_graphs_slice():
    """The modules of the graphs slice (the CUDA graphs, the launch
    registry, the aug experiment's and the graphed fit's scripts) are
    among those the import check walks."""
    import pkgutil
    import radmmm_torch
    walked = {m.name for m in pkgutil.walk_packages(radmmm_torch.__path__,
                                                    "radmmm_torch.")}
    assert {"radmmm_torch.utils.graphs", "radmmm_torch.utils.launches",
            "radmmm_torch.training.step", "radmmm_torch.serving",
            "radmmm_torch.scripts.aug_disentangle_experiment",
            "radmmm_torch.scripts.graph_fit_memory"} <= walked


@pytest.mark.parametrize("script", ["examples/torch_synthesize.py",
                                    "chip_smoke.py"])
def test_port_scripts_import_no_jax(script):
    """The port's scripts outside the package import nothing of JAX or
    of the JAX package, in their source and when imported."""
    assert not _jax_imports(REPO / script)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', {script!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'radmmm_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
