"""Multi-resolution STFT losses (spectral convergence + log magnitude).

Counterpart of ``radmmm_tpu/losses/stft_loss.py``, the reconstruction loss
of the end-to-end waveform decoder. The spectra use the JAX package's
framing, not ``torch.stft``'s defaults: reflect padding of n_fft // 2 on
both sides (``ops.stft.frame_signal``), a periodic Hann window of
win_length zero-padded to the centre of the n_fft frame, and a real FFT;
magnitudes are clamped at sqrt(1e-7).

With lengths (``len_ratios``) the two losses are means over the valid
frames of the global batch: each normaliser (frames, or frames x bins) is
summed over the data group of the current mesh, so under data parallelism
each rank's loss is its items' share of the global batch's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from radmmm_torch.ops.stft import frame_signal, hann_window
from radmmm_torch.parallel import mesh
from radmmm_torch.utils.masking import mask_from_lengths


def _window(fft_size: int, win_length: int, like: torch.Tensor):
    win = hann_window(win_length)
    if win_length < fft_size:
        lpad = (fft_size - win_length) // 2
        win = np.pad(win, (lpad, fft_size - win_length - lpad))
    return torch.as_tensor(win, device=like.device, dtype=like.dtype)


def complex_stft(x: torch.Tensor, fft_size: int, hop_size: int,
                 win_length: int) -> torch.Tensor:
    """(B, T) -> complex (B, n_frames, fft_size // 2 + 1)."""
    frames = frame_signal(x, fft_size, hop_size)
    return torch.fft.rfft(frames * _window(fft_size, win_length, x),
                          n=fft_size, dim=-1)


def stft_magnitude(x: torch.Tensor, fft_size: int, hop_size: int,
                   win_length: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, fft_size // 2 + 1), centred frames."""
    spec = complex_stft(x, fft_size, hop_size, win_length)
    return torch.sqrt(torch.clamp_min(spec.abs() ** 2, 1e-7))


def _lens_mask(y_mag, len_ratios):
    lens = torch.ceil(len_ratios * y_mag.shape[1]).to(torch.int32)
    return mask_from_lengths(lens, y_mag.shape[1]).to(y_mag.dtype), lens


def spectral_convergence_loss(x_mag, y_mag, len_ratios=None):
    """||y - x||_F / ||y||_F; with ``len_ratios`` (each item's share of
    the longest) a mean over valid frames of the per-frame ratio."""
    if len_ratios is None:
        return (torch.linalg.vector_norm(y_mag - x_mag)
                / torch.linalg.vector_norm(y_mag).clamp_min(1e-12))
    m, lens = _lens_mask(y_mag, len_ratios)
    num = torch.sqrt(((y_mag - x_mag) ** 2 * m[..., None]).sum(dim=-1))
    den = torch.sqrt((y_mag ** 2 * m[..., None]).sum(dim=-1))
    per_frame = num / den.clamp_min(1e-12) * m
    return per_frame.sum() / mesh.data_sum(lens.sum()).clamp_min(1)


def log_stft_magnitude_loss(x_mag, y_mag, len_ratios=None,
                            log_offset: float = 0.0):
    """L1 of the log magnitudes; ``log_offset`` 1.0 is the A-weighted
    variant's log(mag + 1)."""
    err = torch.abs(torch.log(y_mag + log_offset)
                    - torch.log(x_mag + log_offset))
    if len_ratios is None:
        return err.mean()
    m, _ = _lens_mask(y_mag, len_ratios)
    d = y_mag.shape[-1]
    return (err * m[..., None]).sum() / (
        mesh.data_sum(m.sum()) * d).clamp_min(1.0)


def a_weights(sampling_rate: int, fft_size: int) -> np.ndarray:
    """The standard A-weighting curve over the rfft bins."""
    f = np.linspace(0, sampling_rate / 2.0, fft_size // 2 + 1)
    return ((12194.0 ** 2 * f ** 4)
            / ((f ** 2 + 20.6 ** 2)
               * np.sqrt((f ** 2 + 107.7 ** 2) * (f ** 2 + 737.9 ** 2))
               * (f ** 2 + 12194.0 ** 2)))


class ComplexSTFTLoss:
    """sum(log(sqrt(clamp(|Y - Y_hat|², 1e-7)))): the magnitude of the
    complex error between the target's and the prediction's STFTs."""

    def __init__(self, fft_size=1024, shift_size=120, win_length=600):
        self.fft_size, self.shift_size = fft_size, shift_size
        self.win_length = win_length

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        Y = complex_stft(y, self.fft_size, self.shift_size, self.win_length)
        Y_hat = complex_stft(y_hat, self.fft_size, self.shift_size,
                             self.win_length)
        err2 = (Y - Y_hat).abs() ** 2
        return torch.log(torch.sqrt(torch.clamp_min(err2, 1e-7))).sum()


class MultiResolutionComplexSTFTLoss:
    """The complex STFT loss averaged over several resolutions."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 sampling_rate: int = 22050):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("one hop and one window length per FFT size")
        self.losses = [ComplexSTFTLoss(f, s, w)
                       for f, s, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x, y = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        return sum(f(x, y) for f in self.losses) / len(self.losses)


class MultiResolutionSTFTLoss:
    """Spectral convergence and log magnitude losses averaged over several
    resolutions -> (sc, mag)."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 sampling_rate: int = 22050, a_weighting: bool = False):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("one hop and one window length per FFT size")
        self.resolutions = list(zip(fft_sizes, hop_sizes, win_lengths))
        self.log_offset = 1.0 if a_weighting else 0.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 len_ratios: Optional[torch.Tensor] = None):
        if x.dim() == 3:
            x, y = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        sc_total, mag_total = 0.0, 0.0
        for fft_size, hop, win in self.resolutions:
            x_mag = stft_magnitude(x, fft_size, hop, win)
            y_mag = stft_magnitude(y, fft_size, hop, win)
            sc_total = sc_total + spectral_convergence_loss(x_mag, y_mag,
                                                            len_ratios)
            mag_total = mag_total + log_stft_magnitude_loss(
                x_mag, y_mag, len_ratios, self.log_offset)
        n = len(self.resolutions)
        return sc_total / n, mag_total / n
