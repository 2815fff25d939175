"""STFT and log-mel feature extraction.

Counterpart of ``radmmm_tpu/ops/stft.py`` (the reference's conv STFT +
librosa mel basis + log-clamp compression): reflect padding by n_fft // 2,
a periodic Hann window centre-padded to n_fft, the magnitude of an n_fft
real FFT at hop_length stride, the Slaney mel basis with Slaney area
normalisation, log(clamp(mel, 1e-5)). The window and the basis are built
in numpy float64 exactly as there; the framing, FFT and projection run in
torch on the device of the waveform.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _hz_to_mel_slaney(f):
    """Slaney-style Hz -> mel (librosa's default, htk=False)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if f.ndim:
        log_t = f >= min_log_hz
        mels[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep
                                           * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   dtype=np.float32) -> np.ndarray:
    """Slaney mel filterbank (n_mels, n_fft // 2 + 1), librosa's
    ``filters.mel`` with htk=False and norm='slaney'."""
    if fmax is None:
        fmax = float(sampling_rate) / 2
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, float(sampling_rate) / 2, n_freqs,
                            endpoint=True)
    min_mel = _hz_to_mel_slaney(fmin)
    max_mel = _hz_to_mel_slaney(fmax)
    mel_pts = _mel_to_hz_slaney(np.linspace(min_mel, max_mel, n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int
                 ) -> torch.Tensor:
    """(B, T) -> reflect-padded frames (B, 1 + T // hop_length, n_fft)."""
    pad = n_fft // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(1, n_fft, hop_length)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5
                              ) -> torch.Tensor:
    """log(clamp(x, min=clip_val))."""
    return torch.log(torch.clamp_min(x, clip_val))


def dynamic_range_decompression(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


class MelSpectrogram:
    """Batched waveform -> log-mel, (B, T) in [-1, 1] -> (B, n_frames,
    n_mels) (channels last). The window and the basis move to the
    waveform's device on first use there."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: Optional[float] = None):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        win = hann_window(win_length)
        if win_length < filter_length:              # centre-pad, as librosa
            lpad = (filter_length - win_length) // 2
            win = np.pad(win, (lpad, filter_length - win_length - lpad))
        self.window = torch.from_numpy(win)
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sampling_rate, filter_length, n_mel_channels,
                           mel_fmin, mel_fmax))

    def _on(self, device):
        if self.window.device != device:
            self.window = self.window.to(device)
            self.mel_basis = self.mel_basis.to(device)

    def stft(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T) -> complex (B, n_frames, n_fft // 2 + 1)."""
        self._on(y.device)
        frames = frame_signal(y, self.filter_length, self.hop_length)
        return torch.fft.rfft(frames * self.window, n=self.filter_length,
                              dim=-1)

    def stft_magnitude(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, n_frames, n_fft // 2 + 1) magnitudes."""
        return self.stft(y).abs()

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, n_frames, n_mels) log-mel."""
        mel = torch.matmul(self.stft_magnitude(y), self.mel_basis.T)
        return dynamic_range_compression(mel)

    def n_frames(self, n_samples: int) -> int:
        return 1 + n_samples // self.hop_length
