"""Waveform augmentations: formant, pitch and duration scaling.

Counterpart of ``radmmm_tpu/data/wave_transforms.py``. The three controls
of the reference's Praat "Change speaker" are built from two batched DSP
primitives, a phase-vocoder time stretch and a linear resampler:

* duration scale d: phase-vocoder time stretch by d (pitch unchanged);
* pitch scale p: stretch by p, then resample back to length (pitch and
  formants move together);
* formant scale f: the pitch-adaptive true-envelope estimate of each
  frame's log spectrum is warped in frequency, the harmonic residual kept,
  so pitch stays while the formant peaks move by f.

Augmented copies get fresh speaker ids: id + n_speakers * aug_index.
Augmentation is loader-thread data work: ``WaveAugmentations.apply`` runs
on CPU tensors in the loader's threads, never on the card. The phase
accumulation runs frame by frame, the order of the JAX scan. Each
transform computes in its input's dtype (float32 from ``apply``), with the
window and the envelope's lifter in float32, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from radmmm_torch.ops.stft import hann_window


def resample_linear(x: torch.Tensor, ratio: float, out_len: int
                    ) -> torch.Tensor:
    """(B, T) -> (B, out_len): playback-rate change by ``ratio`` (ratio > 1
    reads faster: higher pitch, shorter signal)."""
    T = x.shape[1]
    pos = torch.arange(out_len, dtype=x.dtype) * ratio
    i0 = torch.clamp(torch.floor(pos).long(), 0, T - 1)
    i1 = torch.clamp(i0 + 1, 0, T - 1)
    frac = (pos - i0.to(pos.dtype))[None, :]
    valid = (pos < T - 1)[None, :]
    out = x[:, i0] * (1 - frac) + x[:, i1] * frac
    return out * valid


def _stft_frames(x, n_fft, hop, window):
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return torch.fft.rfft(x.unfold(1, n_fft, hop) * window, dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int, window: torch.Tensor,
                 out_len: int) -> torch.Tensor:
    """(B, F, n_fft) windowed frames -> (B, out_len): overlap-add divided
    by the window's sum of squares, the centre padding removed, cut or
    zero-padded to ``out_len``."""
    B, n_frames, n_fft = frames.shape
    T_out = n_fft + hop * (n_frames - 1)
    idx = (torch.arange(n_frames) * hop)[:, None] + torch.arange(n_fft)[None]
    idx = idx.reshape(-1)
    sig = torch.zeros((B, T_out), dtype=frames.dtype).index_add_(
        1, idx, frames.reshape(B, -1))
    wss = torch.zeros((T_out,), dtype=frames.dtype).index_add_(
        0, idx, (window ** 2).to(frames.dtype).expand(n_frames, n_fft)
        .reshape(-1))
    sig = torch.where(wss > 1e-9, sig / torch.clamp_min(wss, 1e-9), sig)
    sig = sig[:, n_fft // 2:]
    if sig.shape[1] >= out_len:
        return sig[:, :out_len]
    return F.pad(sig, (0, out_len - sig.shape[1]))


def phase_vocoder_stretch(x: torch.Tensor, rate: float, out_len: int,
                          n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Time-stretch (B, T) by 1/rate (rate > 1: shorter output) at constant
    pitch, with the classic phase-vocoder phase propagation."""
    window = torch.from_numpy(hann_window(n_fft))
    spec = _stft_frames(x, n_fft, hop, window)          # (B, F, bins)
    B, n_frames, n_bins = spec.shape

    out_frames = max(int(np.ceil(out_len / hop)) + 1, 2)
    t = torch.arange(out_frames, dtype=x.dtype) * rate
    i0 = torch.clamp(torch.floor(t).long(), 0, n_frames - 2)
    frac = (t - i0)[None, :, None]
    mag = (1 - frac) * spec[:, i0].abs() + frac * spec[:, i0 + 1].abs()

    omega = 2.0 * math.pi * torch.arange(n_bins, dtype=x.dtype) \
        * hop / n_fft
    phase = torch.angle(spec)
    dphase = phase[:, 1:] - phase[:, :-1] - omega[None, None, :]
    dphase = dphase - 2 * math.pi * torch.round(dphase / (2 * math.pi))
    inst_sel = (omega[None, None, :] + dphase)[:, i0]    # (B, out_F, bins)

    ph = phase[:, 0]
    phases = []
    for k in range(out_frames):
        ph = ph + inst_sel[:, k]
        phases.append(ph)
    out_spec = torch.polar(mag, torch.stack(phases, 1))
    frames = torch.fft.irfft(out_spec, n=n_fft, dim=-1) * window
    return _overlap_add(frames, hop, window, out_len)


def pitch_shift(x: torch.Tensor, ratio: float, out_len: int) -> torch.Tensor:
    """Shift pitch (and formants) by ``ratio``, duration kept: stretch to
    T * ratio at constant pitch, then resample by ratio."""
    T = x.shape[1]
    stretched = phase_vocoder_stretch(x, 1.0 / ratio, int(T * ratio) + 2)
    return resample_linear(stretched, ratio, out_len)


def _spectral_envelope(log_mag: torch.Tensor, n_fft: int,
                       sampling_rate: float = 22050.0,
                       f0_min: float = 80.0, f0_max: float = 640.0,
                       n_iter: int = 3) -> torch.Tensor:
    """Pitch-adaptive true-envelope estimate of (B, F, bins) log spectra:
    a lifter just below each frame's pitch quefrency, then the update
    env <- smooth(max(log_mag, env)) so the envelope rides the harmonic
    peaks (Roebel & Rodet 2005)."""
    n_bins = log_mag.shape[-1]
    q = torch.arange(n_fft)

    def smooth(lm, keep):
        ceps = torch.fft.irfft(lm, n=n_fft, dim=-1)
        return torch.fft.rfft(ceps * keep, n=n_fft, dim=-1).real[..., :n_bins]

    ceps0 = torch.fft.irfft(log_mag, n=n_fft, dim=-1)
    qlo = max(2, int(sampling_rate / f0_max))
    qhi = min(n_fft // 2, int(sampling_rate / f0_min) + 1)
    pitch_q = qlo + torch.argmax(ceps0[..., qlo:qhi], dim=-1)   # (B, F)
    lifter = torch.clamp(0.75 * pitch_q.to(torch.float32),
                         16.0, 0.45 * n_fft)[..., None]
    keep = ((q[None, None, :] < lifter)
            | (q[None, None, :] > n_fft - lifter)).to(log_mag.dtype)
    env = smooth(log_mag, keep)
    for _ in range(n_iter):
        env = smooth(torch.maximum(log_mag, env), keep)
    return env


def formant_shift(x: torch.Tensor, ratio: float, out_len: int,
                  n_fft: int = 1024, hop: int = 256,
                  sampling_rate: float = 22050.0) -> torch.Tensor:
    """Shift formants by ``ratio`` with pitch kept (Praat's
    formant_shift_ratio): each frame's envelope is warped,
    env'(f) = env(f / ratio), its harmonic residual and phase kept."""
    window = torch.from_numpy(hann_window(n_fft))
    spec = _stft_frames(x, n_fft, hop, window)
    mag = torch.clamp_min(spec.abs(), 1e-8)
    phase = torch.angle(spec)
    n_bins = mag.shape[-1]

    log_mag = torch.log(mag)
    env_log = _spectral_envelope(log_mag, n_fft, sampling_rate)
    excitation_log = log_mag - env_log

    pos = torch.arange(n_bins, dtype=x.dtype) / ratio
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_bins - 1)
    i1 = torch.clamp(i0 + 1, 0, n_bins - 1)
    frac = pos - i0
    env_warp = env_log[..., i0] * (1 - frac) + env_log[..., i1] * frac

    out_spec = torch.polar(torch.exp(excitation_log + env_warp), phase)
    frames = torch.fft.irfft(out_spec, n=n_fft, dim=-1) * window
    return _overlap_add(frames, hop, window, out_len)


def duration_scale(x: torch.Tensor, factor: float, out_len: int
                   ) -> torch.Tensor:
    """Praat's duration_factor: the output is ``factor`` times as long, at
    the same pitch."""
    return phase_vocoder_stretch(x, 1.0 / factor, out_len)


@dataclasses.dataclass
class WaveAugmentations:
    """Probabilistic per-item augmentation config (the reference's
    wave_transforms.py:82-160): either a categorical choice over fixed
    (type, scale) pairs (``aug_types``, entry 0 conventionally "none"), or
    ``aug_probability`` of drawing each enabled factor uniformly from its
    range."""
    aug_probability: float = 0.4
    use_formant_scaling: bool = True
    formant_range: tuple = (0.875, 1.125)
    use_pitch_scaling: bool = False
    pitch_range: tuple = (0.9, 1.1)
    use_duration_scaling: bool = False
    duration_range: tuple = (0.9, 1.1)
    n_augmentations: int = 1
    aug_types: Optional[list] = None
    aug_scales: Optional[list] = None
    aug_probabilities: Optional[list] = None
    aug_languages_applicable: Optional[list] = None
    num_aug_in_batch: int = 0
    randomize_transform: bool = False

    @classmethod
    def from_config(cls, cfg: Optional[dict]):
        """This class's keywords or the reference's wave_aug_config
        schema (aug_types / aug_scales / aug_probabilities ...)."""
        cfg = dict(cfg or {})
        if cfg.get("aug_types"):
            n = sum(1 for t in cfg["aug_types"] if t != "none")
            cfg.setdefault("n_augmentations", n)
        return cls(**cfg)

    def sample(self, rng: np.random.Generator, language: Optional[str] = None):
        """The host's decision: (apply?, aug_index, factors)."""
        if self.aug_types:
            if (self.aug_languages_applicable is not None
                    and language is not None
                    and language not in self.aug_languages_applicable):
                return False, 0, {}
            p = np.asarray(self.aug_probabilities, np.float64)
            choice = int(rng.choice(len(self.aug_types), p=p / p.sum()))
            if self.aug_types[choice] == "none":
                return False, 0, {}
            scale = float(self.aug_scales[choice])
            if self.randomize_transform:
                scale = float(rng.uniform(min(scale, 1.0), max(scale, 1.0)))
            kind = self.aug_types[choice].replace("scale_", "")
            # augmentation ids count only the non-"none" entries, in order
            aug_index = sum(1 for t in self.aug_types[:choice + 1]
                            if t != "none")
            return True, aug_index, {kind: scale}
        if rng.uniform() > self.aug_probability:
            return False, 0, {}
        aug_index = int(rng.integers(1, self.n_augmentations + 1))
        factors = {}
        if self.use_formant_scaling:
            factors["formant"] = float(rng.uniform(*self.formant_range))
        if self.use_pitch_scaling:
            factors["pitch"] = float(rng.uniform(*self.pitch_range))
        if self.use_duration_scaling:
            factors["duration"] = float(rng.uniform(*self.duration_range))
        return True, aug_index, factors

    def max_duration_factor(self) -> float:
        """The largest duration stretch any sampled augmentation applies
        (>= 1): shapes scheduled from filelist durations scale by it so
        augmented audio still fits."""
        f = 1.0
        if self.aug_types:
            for t, s in zip(self.aug_types, self.aug_scales or []):
                if t != "none" and t.replace("scale_", "") == "duration":
                    f = max(f, float(s))
        elif self.use_duration_scaling:
            f = max(f, float(max(self.duration_range)))
        return f

    def apply(self, audio: np.ndarray, factors: dict) -> np.ndarray:
        """The sampled factors applied to (T,) audio on the CPU."""
        x = torch.from_numpy(np.asarray(audio, np.float32))[None, :]
        T = x.shape[1]
        if "formant" in factors and abs(factors["formant"] - 1.0) > 1e-4:
            x = formant_shift(x, factors["formant"], T)
        if "pitch" in factors and abs(factors["pitch"] - 1.0) > 1e-4:
            x = pitch_shift(x, factors["pitch"], T)
        if "duration" in factors and abs(factors["duration"] - 1.0) > 1e-4:
            x = duration_scale(x, factors["duration"],
                               int(T * factors["duration"]))
        return x[0].numpy()

    def remap_speaker_id(self, speaker_id: int, aug_index: int,
                         n_speakers: int) -> int:
        """Augmented copies get distinct speaker ids (the reference's
        tts_lightning_modules.py:127-131)."""
        return speaker_id + n_speakers * aug_index
