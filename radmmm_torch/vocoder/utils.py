"""Vocoder loading and dispatch, and mel -> audio helpers.

Counterpart of ``radmmm_tpu/vocoder/utils.py`` (the reference's
vocoders/vocoder_utils.py:35-143). ``get_vocoder`` loads

* an upstream HiFi-GAN ``g_*`` file (a torch state dict, under
  ``"generator"`` or bare) with its config json;
* an upstream WaveGlow file (the vendored tree's state dict under
  ``"model"``, weight-normed or not, or a pickled module) with its
  config json;
* the run directory of the port's ``vocoder-fit`` (``ckpt/<step>/
  state.pt`` beside ``generator_config.json``), HiFi-GAN only, as in the
  JAX package. The JAX package's run directories are orbax checkpoints,
  which the port does not read.

With no checkpoint configured it returns (None, None) and the caller uses
``GriffinLimVocoder``, which synthesises through the pseudo-inverse of the
mel basis. Vocoding is batched, on the device the vocoder was loaded to.

The JAX package jits a vocoder's apply. ``vocode_program`` is the
counterpart: the apply and the Denoiser as one program through
``utils/graphs.Graphed`` (one CUDA graph per mel shape on the card, eager
on the CPU), a WaveGlow's noise drawn eagerly and passed in. Griffin-Lim
stays eager, as the JAX package runs it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from radmmm_torch.ops.stft import (MelSpectrogram,
                                   dynamic_range_decompression, griffin_lim,
                                   mel_filterbank)
from radmmm_torch.utils.checkpoint import CheckpointManager
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import GraphPool, graph_program
from radmmm_torch.vocoder.hifigan import (Denoiser, Generator, HiFiGANConfig,
                                          load_torch_generator_params)


def load_hifigan_config(config_path: str) -> HiFiGANConfig:
    """The upstream generator config json (e.g. config_16khz.json)."""
    with open(config_path) as f:
        h = json.load(f)
    return HiFiGANConfig(
        resblock=str(h.get("resblock", "1")),
        upsample_rates=tuple(h["upsample_rates"]),
        upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        upsample_initial_channel=h["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in h["resblock_dilation_sizes"]),
        n_mel_channels=h.get("num_mels", 80),
        sampling_rate=h.get("sampling_rate", 22050),
    )


def hifigan_fns(gen: Generator, with_denoiser: bool, device):
    """(generator_fn, denoiser) of a HiFi-GAN generator (either head) on
    ``device``: what ``get_vocoder`` returns for a loaded one."""
    gen = gen.to(device).eval()

    def generator_fn(mel) -> torch.Tensor:
        with torch.no_grad():
            return gen(torch.as_tensor(mel, device=device))

    denoiser = (Denoiser(generator_fn, n_mel_channels=gen.config.n_mel_channels,
                         device=device)
                if with_denoiser else None)
    return generator_fn, denoiser


def _load_native_vocoder(vocoder_type: str, run_dir: str,
                         vocoder_config_path, with_denoiser: bool, device):
    """A ``vocoder-fit`` output directory (or its ``ckpt`` subdirectory):
    the generator of its latest checkpoint, rebuilt from the
    generator_config.json the loop writes beside it."""
    run_dir = os.path.abspath(str(run_dir))
    ckpt_dir = (run_dir if os.path.basename(run_dir) == "ckpt"
                or not os.path.isdir(os.path.join(run_dir, "ckpt"))
                else os.path.join(run_dir, "ckpt"))
    cfg_path = (vocoder_config_path
                if vocoder_config_path
                and str(vocoder_config_path).endswith(".json")
                and os.path.exists(str(vocoder_config_path))
                else os.path.join(os.path.dirname(ckpt_dir),
                                  "generator_config.json"))
    gen_kwargs = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            gen_kwargs = json.load(f)
    if vocoder_type != "hifigan":
        raise ValueError("native checkpoint loading is implemented for "
                         "hifigan runs (vocoder-fit default)")
    payload, step = CheckpointManager(ckpt_dir).load_payload()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    gen = Generator(HiFiGANConfig.from_dict(gen_kwargs))
    gen.load_state_dict(payload["gen"])
    return hifigan_fns(gen, with_denoiser, device)


def load_hifigan_module(vocoder_config_path, ckpt_or_path) -> Generator:
    """The ``Generator`` of an upstream torch checkpoint (a path or its
    loaded dict), on the CPU: the form ``export`` bakes into a serving
    artifact."""
    if isinstance(ckpt_or_path, (str, os.PathLike)):
        ckpt_or_path = torch.load(ckpt_or_path, map_location="cpu",
                                  weights_only=False)
    cfg = (load_hifigan_config(vocoder_config_path)
           if vocoder_config_path and os.path.exists(str(vocoder_config_path))
           else HiFiGANConfig())
    state_dict = ckpt_or_path.get("generator", ckpt_or_path)
    gen = Generator(cfg)
    gen.load_state_dict(load_torch_generator_params(state_dict, cfg))
    return gen


def get_vocoder(vocoder_type: str = "hifigan",
                vocoder_config_path: Optional[str] = None,
                vocoder_checkpoint_path: Optional[str] = None,
                vocoder_map=None, with_denoiser: bool = True,
                device: str | torch.device = "cuda"):
    """-> (generator_fn(mel (B, T, n_mel)) -> (B, T * hop), denoiser or
    None), both on ``device``; (None, None) when no checkpoint is
    configured, and the caller falls back to Griffin-Lim. A configured
    checkpoint that does not load raises. ``vocoder_map`` is accepted as
    in the JAX package's signature; per-speaker vocoders come from
    ``get_vocoder_map``."""
    if vocoder_type not in ("hifigan", "waveglow"):
        raise ValueError(f"unsupported vocoder type {vocoder_type}")
    if not vocoder_checkpoint_path or not os.path.exists(
            str(vocoder_checkpoint_path)):
        return None, None
    device = resolve_device(device)
    if os.path.isdir(str(vocoder_checkpoint_path)):
        return _load_native_vocoder(vocoder_type, vocoder_checkpoint_path,
                                    vocoder_config_path, with_denoiser,
                                    device)
    # a checkpoint file the user configured, as the JAX package reads it
    # (a WaveGlow file may hold a pickled module)
    ckpt = torch.load(vocoder_checkpoint_path, map_location="cpu",
                      weights_only=False)
    if vocoder_type == "hifigan":
        return hifigan_fns(load_hifigan_module(vocoder_config_path, ckpt),
                            with_denoiser, device)

    from radmmm_torch.vocoder.waveglow import (WaveGlow,
                                               load_torch_waveglow_params,
                                               load_waveglow_config)
    state_dict = ckpt.get("model", ckpt)
    if hasattr(state_dict, "state_dict"):       # a pickled nn.Module
        state_dict = state_dict.state_dict()
    wg = WaveGlow(**load_waveglow_config(
        vocoder_config_path if vocoder_config_path
        and os.path.exists(str(vocoder_config_path)) else None))
    wg.load_state_dict(load_torch_waveglow_params(state_dict, wg))
    generator_fn = WaveGlowFn(wg.to(device).eval().cache_inverses(), device)
    denoiser = (Denoiser(lambda mel: generator_fn(mel, sigma=0.0),
                         n_mel_channels=wg.n_mel_channels, device=device)
                if with_denoiser else None)
    return generator_fn, denoiser


class WaveGlowFn:
    """A loaded WaveGlow's apply, ``fn(mel, sigma=0.667, generator=None,
    residual=None)`` -> audio: sigma 0.667 is the reference's default
    (vocoder_utils.py:38), and the noise comes from a generator seeded 0
    unless a generator or the noise itself (``draw``'s) is given."""

    def __init__(self, wg, device):
        self.wg, self.device = wg, device

    def draw(self, mel, sigma: float = 0.667,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.wg.draw_residual(torch.as_tensor(mel, device=self.device),
                                     sigma, generator)

    def __call__(self, mel, sigma: float = 0.667,
                 generator: Optional[torch.Generator] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        mel = torch.as_tensor(mel, device=self.device)
        if residual is None:
            residual = self.draw(mel, sigma, generator)
        with torch.no_grad():
            return self.wg.infer(mel, sigma=sigma, residual=residual)


def get_vocoder_map(vocoder_map: Dict[str, Dict[str, str]],
                    device: str | torch.device = "cuda"):
    """Per-speaker vocoders (vocoder_utils.py vocoder_map): {speaker:
    {vocoder_type, vocoder_config_path, vocoder_checkpoint_path}} ->
    {speaker: (generator_fn, denoiser)}."""
    return {speaker: get_vocoder(cfg.get("vocoder_type", "hifigan"),
                                 cfg.get("vocoder_config_path"),
                                 cfg.get("vocoder_checkpoint_path"),
                                 device=device)
            for speaker, cfg in (vocoder_map or {}).items()}


class GriffinLimVocoder:
    """Log-mel (B, T, n_mels) -> waveform (B, T * hop) through the
    pseudo-inverse of the mel basis and Griffin-Lim, on the mel's
    device."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, n_iters=30):
        self.stft = MelSpectrogram(filter_length, hop_length, win_length,
                                   n_mel_channels, sampling_rate, mel_fmin,
                                   mel_fmax)
        basis = mel_filterbank(sampling_rate, filter_length, n_mel_channels,
                               mel_fmin, mel_fmax)
        self.inv_basis = torch.from_numpy(np.linalg.pinv(basis))
        self.n_iters = n_iters

    def __call__(self, mel: torch.Tensor, phase: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``phase``: the initial phase (B, T, n_fft // 2 + 1), else drawn
        from ``generator``."""
        inv = self.inv_basis.to(mel.device)
        mag = torch.clamp_min(dynamic_range_decompression(mel) @ inv.T, 0.0)
        return griffin_lim(mag, self.stft, phase=phase, generator=generator,
                           n_iters=self.n_iters)


def get_audio_for_mels(mels: torch.Tensor, vocoder_type: str, vocoder_fn,
                       denoiser=None,
                       denoiser_strength: float = 0.005) -> torch.Tensor:
    """Batched mel -> (denoised) audio (vocoder_utils.py:64-132)."""
    audio = vocoder_fn(mels)
    if denoiser is not None:
        audio = denoiser(audio, strength=denoiser_strength)
    return audio


def vocode_program(vocoder_type: str, vocoder_fn, denoiser=None,
                   pool: Optional[GraphPool] = None,
                   denoiser_strength: float = 0.005):
    """``get_audio_for_mels`` as one program, ``vocode(mels)`` -> audio:
    with a ``pool``, the vocoder's apply and the Denoiser through
    ``Graphed`` in it (one graph per mel shape on the card); eager
    without one. A WaveGlow's noise is drawn on the host's side of the
    graph, as its eager call draws it (``WaveGlowFn.draw``), and passed
    in."""
    waveglow = isinstance(vocoder_fn, WaveGlowFn)

    def apply(x):
        fn = ((lambda m: vocoder_fn(m, residual=x["residual"])) if waveglow
              else vocoder_fn)
        return get_audio_for_mels(x["mel"], vocoder_type, fn, denoiser,
                                  denoiser_strength)

    program = graph_program(apply, pool, "vocode")

    def vocode(mels: torch.Tensor) -> torch.Tensor:
        x = {"mel": mels}
        if waveglow:
            x["residual"] = vocoder_fn.draw(mels)
        return program(x)

    return vocode
