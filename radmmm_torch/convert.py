"""Weight bridge: flax variable collections -> the port's state_dicts.

The port names its parameters after the JAX package's leaves, so a leaf's
key is its flax path joined with dots, with these layout rules:

* conv kernels: WIO ``kernel`` (K, C_in, C_out) -> ``weight`` (C_out, C_in, K);
  weight-norm ``v`` likewise, ``g`` per output channel unchanged;
* ``Linear`` ``kernel`` (C_in, C_out) -> ``weight`` (C_out, C_in);
* ``nn.Embed`` ``embedding`` -> ``nn.Embedding`` ``weight``;
* LSTM ``wi_*`` (C, 4H), ``wh_*`` (H, 4H), ``b_ih_*``, ``b_hh_*``: unchanged
  (the kernel takes Wh as (H, 4H));
* spectral norm ``spectral/.../SpectralNormedParam_i/wh_{d}_u`` ->
  ``...sn_{d}.u``;
* the flow steps ``decoder/flow_i`` -> ``decoder.flows.i``; the 1x1s'
  ``p``, ``lower``, ``upper``, ``upper_diag``, ``input_mean`` and
  ``initialized`` unchanged;
* the batch norms' ``batch_stats`` collection (``.../bn/mean``, ``var``)
  -> their ``mean`` and ``var`` buffers, their ``scale`` and ``bias``
  unchanged; the FiLM blocks' and simple conv nets' convs, the
  LSTMConvDAP's ``backbone/lstm`` and ``conv_i`` by the conv and LSTM
  rules above;
* the alternative decoders (``alt_decoder_state_dict_from_jax``): flax
  ``Dense`` ``kernel`` (C_in, C_out) -> ``nn.Linear`` ``weight``, the
  convs by the rules above, an E2E decoder's ``generator`` by HiFi-GAN's;
* HiFi-GAN: ``*_v`` (K, C_in, C_out) -> (C_out, C_in, K), except the
  upsampling ConvTranspose ``up_i_v`` -> (C_in, C_out, K) with ``up_i_g``
  per input channel (the iSTFTNet generator takes the same rules);
* the discriminators: the period discriminator's HWIO ``*_v``
  (K, 1, C_in, C_out) -> (C_out, C_in, K, 1), the scale discriminator's
  WIO ``*_kernel`` (K, C_in / groups, C_out) -> (C_out, C_in / groups, K);
* WaveGlow: ``upsample_kernel_w`` (K, C_in, C_out) -> the ConvTranspose's
  (C_in, C_out, K), the 1x1s' ``weight`` unchanged, its WN convs by the
  conv rules above;
* a training state: the optimizer's moments are parameter-shaped trees and
  take the parameters' rules (``load_jax_train_state``,
  ``load_jax_vocoder_state``);
* a rank of an (n_data, n_model) mesh: ``rank_state_dict`` cuts a full
  state dict to the rank's shards by the TP rules of ``parallel.mesh``.

Inputs are nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``
of the flax variables); nothing here imports JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from radmmm_torch.parallel.mesh import param_spec, shard_tensor

_TTS_COLLECTIONS = ("params", "buffers", "batch_stats", "spectral")


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _put(sd: Dict[str, torch.Tensor], path, value: np.ndarray) -> None:
    key = ".".join(path)
    if key in sd:
        raise ValueError(f"two flax leaves map to {key}")
    sd[key] = torch.from_numpy(np.array(value))   # a C-ordered copy


def _tts_leaf(collection: str, path: Tuple[str, ...], a: np.ndarray):
    path = list(path)
    if collection == "spectral":
        m = re.fullmatch(r"wh_(fwd|bwd)_u", path[-1])
        if not (m and path[-2].startswith("SpectralNormedParam_")):
            raise ValueError(f"unexpected spectral leaf {'/'.join(path)}")
        return path[:-2] + [f"sn_{m.group(1)}", "u"], a
    if len(path) > 1 and path[0] == "decoder" and path[1].startswith("flow_"):
        path[1:2] = ["flows", path[1][len("flow_"):]]
    leaf = path[-1]
    if leaf == "kernel" and a.ndim == 3:
        return path[:-1] + ["weight"], a.transpose(2, 1, 0)
    if leaf == "v" and a.ndim == 3:
        return path, a.transpose(2, 1, 0)
    if leaf == "kernel" and a.ndim == 2:
        return path[:-1] + ["weight"], a.T
    if leaf == "embedding":
        return path[:-1] + ["weight"], a
    return path, a


def tts_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of ``radmmm_torch.models.tts.TTSModel`` from the flax
    collections of a JAX ``TTSModel`` (params, buffers, batch_stats,
    spectral)."""
    extra = set(variables) - set(_TTS_COLLECTIONS)
    if extra:
        raise ValueError(f"collections {sorted(extra)} have no port "
                         "counterpart yet")
    sd: Dict[str, torch.Tensor] = {}
    for col in _TTS_COLLECTIONS:
        for path, a in _flatten(variables.get(col, {})):
            key, value = _tts_leaf(col, path, a)
            _put(sd, key, value)
    return sd


def rank_state_dict(sd: Dict[str, torch.Tensor], n_data: int, n_model: int,
                    rank: int) -> Dict[str, torch.Tensor]:
    """The entries of a full TTS state dict (or a moment tree in its
    names) that rank ``rank`` of an (n_data, n_model) mesh holds: split by
    the TP rules at model index ``rank % n_model``, whole elsewhere (every
    data rank holds the same)."""
    if not 0 <= rank < n_data * n_model:
        raise ValueError(f"rank {rank} outside an {n_data} x {n_model} mesh")
    out = {}
    for k, v in sd.items():
        dim = param_spec(k, v.shape, n_model)
        out[k] = (v if dim is None
                  else shard_tensor(v, dim, n_model, rank % n_model))
    return out


def _moments(opt_state):
    """(count, first, second moment trees) of the RAdam or Adam state in a
    (possibly chained) optax state, found by field name."""
    if hasattr(opt_state, "exp_avg"):
        return int(opt_state.count), opt_state.exp_avg, opt_state.exp_avg_sq
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return int(opt_state.count), opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _moments(sub)
            if found is not None:
                return found
    return None


def load_jax_train_state(state, jax_state) -> None:
    """Load a JAX ``TrainState`` (its leaves as numpy arrays) into a port
    ``training.step.TrainState`` in place: the model's parameters, buffers,
    batch-norm running statistics and spectral-norm vectors, the step
    count, and the optimizer's moments and count, so that both continue
    from the same point."""
    variables = {"params": jax_state.params, "buffers": jax_state.buffers,
                 "batch_stats": jax_state.batch_stats,
                 "spectral": jax_state.spectral}
    state.model.load_state_dict(tts_state_dict_from_jax(variables))
    state.step = int(jax_state.step)
    found = _moments(jax_state.opt_state)
    if found is None:
        raise ValueError("no RAdam or Adam moments in the optimizer state")
    count, first, second = found
    opt = state.optimizer
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    for bufs, tree in ((opt.exp_avg, first), (opt.exp_avg_sq, second)):
        sd = tts_state_dict_from_jax({"params": tree})
        with torch.no_grad():
            for buf, p in zip(bufs, opt.params):
                buf.copy_(sd[name_of[id(p)]])
    opt.count = count


def _hifigan_leaf(path, a: np.ndarray):
    if path[-1].endswith("_v"):
        a = (a.transpose(1, 2, 0) if re.fullmatch(r"up_\d+_v", path[-1])
             else a.transpose(2, 1, 0))
    return path, a


def hifigan_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of ``radmmm_torch.vocoder.hifigan.Generator`` from the
    flax variables of a JAX ``Generator``."""
    extra = set(variables) - {"params"}
    if extra:
        raise ValueError(f"unexpected collections {sorted(extra)}")
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables["params"]):
        _put(sd, *_hifigan_leaf(path, a))
    return sd


def alt_decoder_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of a ``radmmm_torch.models.alt_decoders``
    ``DeterministicDecoder``, ``E2ETTSDecoder`` or ``DiffusionDecoder``
    from the flax variables of its JAX twin."""
    extra = set(variables) - {"params"}
    if extra:
        raise ValueError(f"unexpected collections {sorted(extra)}")
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables["params"]):
        if path[0] == "generator":
            sub, a = _hifigan_leaf(path[1:], a)
            _put(sd, ("generator",) + tuple(sub), a)
        else:
            _put(sd, *_tts_leaf("params", path, a))
    return sd


def discriminator_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of a ``MultiPeriodDiscriminator`` or
    ``MultiScaleDiscriminator`` from the flax variables of its JAX
    twin."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables["params"]):
        if a.ndim == 4:                     # HWIO -> (C_out, C_in, K, 1)
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 3:                   # WIO -> (C_out, C_in, K)
            a = a.transpose(2, 1, 0)
        _put(sd, path, a)
    return sd


def waveglow_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of ``radmmm_torch.vocoder.waveglow.WaveGlow`` from the
    flax variables of a JAX ``WaveGlow``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables["params"]):
        if path[-1] == "upsample_kernel_w":
            _put(sd, path, a.transpose(1, 2, 0))
        else:
            _put(sd, *_tts_leaf("params", path, a))
    return sd


def _load_adam(opt, module_sds, count: int) -> None:
    """Set the moments and count of the port's ``Optimizer`` ``opt`` from
    the moments' state dicts: ``module_sds`` pairs (prefix, module, first,
    second), whose parameters, in order, are ``opt``'s."""
    names = [(prefix + name, first, second)
             for prefix, module, first, second in module_sds
             for name, _ in module.named_parameters()]
    opt.load_state_dict({
        "count": count,
        "exp_avg": [first[name] for name, first, _ in names],
        "exp_avg_sq": [second[name] for name, _, second in names]})


def load_jax_vocoder_state(trainer, jax_state) -> None:
    """Load a JAX ``VocoderTrainState`` or ``WaveGlowTrainState`` (its
    leaves as numpy arrays) into the port's ``HiFiGANTrainer`` or
    ``WaveGlowTrainer`` in place: parameters, the Adam moments and count
    of each optimizer, and the step."""
    trainer.step = int(jax_state.step)
    if not hasattr(jax_state, "gen_params"):
        def wg(tree):
            return waveglow_state_dict_from_jax({"params": tree})
        trainer.model.load_state_dict(wg(jax_state.params))
        count, first, second = _moments(jax_state.opt_state)
        _load_adam(trainer.opt, [("", trainer.model, wg(first),
                                  wg(second))], count)
        return

    def gen(tree):
        return hifigan_state_dict_from_jax({"params": tree})

    def disc(tree):
        return {f"{k}.{n}": t for k in ("mpd", "msd") for n, t in
                discriminator_state_dict_from_jax(
                    {"params": tree[k]}).items()}

    trainer.gen.load_state_dict(gen(jax_state.gen_params))
    trainer.mpd.load_state_dict(discriminator_state_dict_from_jax(
        {"params": jax_state.mpd_params}))
    trainer.msd.load_state_dict(discriminator_state_dict_from_jax(
        {"params": jax_state.msd_params}))
    count, first, second = _moments(jax_state.gen_opt)
    _load_adam(trainer.gen_opt, [("", trainer.gen, gen(first),
                                  gen(second))], count)
    count, first, second = _moments(jax_state.disc_opt)
    first, second = disc(first), disc(second)
    _load_adam(trainer.disc_opt,
               [("mpd.", trainer.mpd, first, second),
                ("msd.", trainer.msd, first, second)], count)
