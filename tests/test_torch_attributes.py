"""radmmm_torch's LSTM-first predictors against their JAX twins on copied,
perturbed weights and the same inputs from a numpy seed: LSTMConv (with
and without batch norm, in eval and in training, where the spectral norms'
u and the batch norms' running statistics move), ResidualLSTMConv, and
LSTMConvDAP forward, ``targets`` and ``infer``; then a TTSModel with an
LSTMConvDAP duration predictor (tracked stack (2)'s shape): its training
forward's duration outputs and both serving stages.

Dropout is 0 in the training comparisons (the frameworks draw other
bits). Tolerance: 1e-5 for single modules (f32 on both sides, JAX at
matmul precision 'highest'), 1e-4 for a whole model's stages, as
tests/test_torch_models.py; integer durations must be equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models import attributes as J
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.models import attributes as P
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.utils.masking import SeqLens
from tests.test_torch_convert import perturb
from tests.test_tts_model import tiny_batch, tiny_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
STAGE_ATOL = 1e-4
B, T, C = 3, 10, 6
LENGTHS = (10, 7, 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=atol, atol=atol)


def _x(seed=0, c=C):
    return np.random.default_rng(seed).standard_normal(
        (B, T, c)).astype(np.float32)


def _lens():
    return (JaxSeqLens.create(jnp.asarray(LENGTHS), T),
            SeqLens.create(_t(LENGTHS), T))


def _init(module, *args, **kw):
    variables = jax.jit(functools.partial(module.init, **kw))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args)
    return perturb(variables, seed=3)


def _port(module, variables):
    module.load_state_dict(tts_state_dict_from_jax(variables))
    return module


def _mutated_close(port, mut):
    """The port's buffers against JAX's mutated collections."""
    sd = port.state_dict()
    want = tts_state_dict_from_jax(mut)
    assert want
    for k, w in want.items():
        _close(sd[k], w.numpy())


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_lstm_conv(use_bn, train):
    x = _x()
    jl, tl = _lens()
    jm = J.LSTMConv(out_dim=3, n_layers=3, n_channels=8, p_dropout=0.0,
                    use_bn=use_bn)
    v = _init(jm, jnp.asarray(x), jl, train=False)
    port = _port(P.LSTMConv(C, 3, 3, 8, p_dropout=0.0, use_bn=use_bn), v)
    want, mut = jm.apply(v, jnp.asarray(x), jl, train=train,
                         mutable=["batch_stats", "spectral"],
                         rngs={"dropout": jax.random.key(2)})
    _close(port(_t(x), tl, train=train), want)
    if train:
        _mutated_close(port, mut)


def test_residual_lstm_conv():
    x = _x()
    jl, tl = _lens()
    jm = J.ResidualLSTMConv(out_dim=C, n_layers=2, n_hidden_channels=8)
    v = _init(jm, jnp.asarray(x), jl, train=False)
    port = _port(P.ResidualLSTMConv(C, 2, 8), v)
    _close(port(_t(x), tl), jm.apply(v, jnp.asarray(x), jl, train=False))


DAP = dict(n_speaker_dim=4, in_dim=16, out_dim=1, reduction_factor=2,
           n_backbone_layers=2, n_hidden=8, kernel_size=3, log_target=True)


@functools.lru_cache(maxsize=None)
def _dap(p_dropout=0.25):
    txt = _x(1, 16)
    spk = np.random.default_rng(2).standard_normal((B, 4)).astype(np.float32)
    jl, _ = _lens()
    jm = J.LSTMConvDAP(p_dropout=p_dropout, **DAP)
    v = _init(jm, None, jnp.asarray(txt), jnp.asarray(spk), jl, train=False)
    return jm, v, txt, spk


@pytest.mark.parametrize("train", [False, True])
def test_lstm_conv_dap_forward(train):
    jm, v, txt, spk = _dap(0.0)
    jl, tl = _lens()
    tgt = np.random.default_rng(4).uniform(1, 5, (B, T, 1)).astype(
        np.float32)
    # accent and speaker stats are taken and ignored, as in the JAX module
    acc = np.ones((B, 2), np.float32)
    want, mut = jm.apply(v, jnp.asarray(tgt), jnp.asarray(txt),
                         jnp.asarray(spk), jl, x_mean=jnp.ones(B),
                         x_std=jnp.ones(B), accent_emb=jnp.asarray(acc),
                         train=train, mutable=["spectral"])
    port = _port(P.LSTMConvDAP(p_dropout=0.0, **DAP), v)
    got = port(_t(txt), _t(spk), tl, x_mean=torch.ones(B),
               x_std=torch.ones(B), accent_emb=_t(acc), train=train)
    _close(got, want["x_hat"])
    _close(port.targets(_t(tgt), torch.ones(B), torch.ones(B)), want["x"])
    if train:
        _mutated_close(port, mut)


def test_lstm_conv_dap_infer():
    jm, v, txt, spk = _dap()
    jl, tl = _lens()
    want = jm.apply(v, jnp.asarray(txt), jnp.asarray(spk), jl,
                    method=J.LSTMConvDAP.infer)
    port = _port(P.LSTMConvDAP(**DAP), v)
    _close(port.infer(_t(txt), _t(spk), tl), want)
    _close(port.inv_tx(port(_t(txt), _t(spk), tl)), want)


# -- a TTSModel with an LSTMConvDAP duration predictor ---------------------

def stack2_tiny_config(**kw):
    """tests/test_tts_model.py's tiny model shaped as tracked stack (2):
    the LSTMConvDAP duration predictor (speaker only), no accent in the
    encoder or the alignment, the decoder's accent embedding on."""
    dur = dict(_class="LSTMConvDAP", n_speaker_dim=4, in_dim=16, out_dim=1,
               reduction_factor=2, n_backbone_layers=2, n_hidden=8,
               kernel_size=3, p_dropout=0.5, log_target=True)
    base = tiny_config()
    decoder = dict(base.decoder, n_text_dim=16,
                   use_accent_emb_for_decoder=True)
    frame = {k: dict(getattr(base, k), in_dim=16, n_accent_dim=0,
                     use_accent_embedding=False)
             for k in ("f0_predictor", "energy_predictor",
                       "voiced_predictor")}
    return dataclasses.replace(
        base, use_accent_emb_for_encoder=False,
        use_speaker_emb_for_alignment=False, decoder=decoder,
        duration_predictor=dur, **frame, **kw)


@functools.lru_cache(maxsize=None)
def stack2_models():
    cfg = stack2_tiny_config()
    jm = JaxTTSModel(config=cfg)
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        tiny_batch(np.random.default_rng(0)))
    v = perturb(v, seed=5)
    port = TTSModel(TTSConfig(**dataclasses.asdict(cfg)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    assert isinstance(port.duration_predictor, P.LSTMConvDAP)
    return jm, v, port.eval().cache_inverses()


def test_tts_forward_with_an_lstm_conv_dap():
    jm, v, port = stack2_models()
    batch = tiny_batch(np.random.default_rng(1))
    want = jm.apply(v, batch, binarize=True, train=False)
    with torch.no_grad():
        got = port({k: _t(a) for k, a in batch.items()}, binarize=True,
                   train=False)
    for key in ("duration_outputs", "f0_outputs", "voiced_outputs"):
        for part in ("x_hat", "x"):
            _close(got[key][part], want[key][part], STAGE_ATOL)
    _close(got["z_mel"], want["z_mel"], STAGE_ATOL)


def test_serving_stages_with_an_lstm_conv_dap():
    jm, v, port = stack2_models()
    rng = np.random.default_rng(6)
    text = rng.integers(1, 30, (2, 7)).astype(np.int32)
    lens, spk, acc = (np.asarray([7, 4], np.int32),
                      np.asarray([0, 2], np.int32),
                      np.asarray([1, 0], np.int32))
    want = jm.apply(v, *map(jnp.asarray, (text, lens, spk)),
                    accent_ids=jnp.asarray(acc),
                    method=JaxTTSModel.infer_durations)
    with torch.inference_mode():
        got = port.infer_durations(_t(text), _t(lens), _t(spk),
                                   accent_ids=_t(acc))
    _close(got["txt_enc"], want["txt_enc"], STAGE_ATOL)
    np.testing.assert_array_equal(got["durations"].numpy(),
                                  np.asarray(want["durations"]))
    f0m, f0s = np.array([5.0, 5.2], np.float32), np.array([.3, .4],
                                                         np.float32)
    dec = jm.apply(v, jax.random.key(0), want["txt_enc"], want["durations"],
                   jnp.asarray(spk), accent_ids=jnp.asarray(acc),
                   f0_mean=f0m, f0_std=f0s, sigma=0.0, max_frames=48,
                   method=JaxTTSModel.infer_decode)
    with torch.inference_mode():
        out = port.infer_decode(_t(want["txt_enc"]), _t(want["durations"]),
                                _t(spk), accent_ids=_t(acc),
                                f0_mean=_t(f0m), f0_std=_t(f0s), sigma=0.0,
                                max_frames=48)
    np.testing.assert_array_equal(out["voiced"].numpy(),
                                  np.asarray(dec["voiced"]))
    for k in ("f0", "energy", "mel"):
        _close(out[k], dec[k], STAGE_ATOL)
