"""Vocoder dispatch and mel -> audio helpers.

Counterpart of the parts of ``radmmm_tpu/vocoder/utils.py`` that training
reaches (the reference's vocoders/vocoder_utils.py:35-143): a Griffin-Lim
vocoder over the pseudo-inverse of the mel basis, used when no vocoder
checkpoint is configured, ``get_vocoder``'s unconfigured branch and
``get_audio_for_mels``. Loading a HiFi-GAN or WaveGlow checkpoint comes
with ROADMAP item M9.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from radmmm_torch.ops.stft import (MelSpectrogram,
                                   dynamic_range_decompression, griffin_lim,
                                   mel_filterbank)


def get_vocoder(vocoder_type: str = "hifigan",
                vocoder_config_path: Optional[str] = None,
                vocoder_checkpoint_path: Optional[str] = None):
    """-> (generator_fn, denoiser). (None, None) when no checkpoint is
    configured, and the caller falls back to Griffin-Lim."""
    if vocoder_type not in ("hifigan", "waveglow"):
        raise ValueError(f"unsupported vocoder type {vocoder_type}")
    if not vocoder_checkpoint_path or not os.path.exists(
            str(vocoder_checkpoint_path)):
        return None, None
    raise NotImplementedError(
        f"loading a {vocoder_type} checkpoint ({vocoder_checkpoint_path}) "
        "comes with ROADMAP item M9; leave vocoder_checkpoint_path null "
        "for Griffin-Lim audio")


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
