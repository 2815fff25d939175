"""Host collation and the batch featurizer in plain PyTorch: a frozen copy
of the port's ``data/collate.py`` without its CUDA graphs. ``collate_host``
pads raw audio and text into numpy arrays; ``Featurizer.featurize_raw``
computes the log-mel, the pYIN F0 with its voicing, the energy and the
beta-binomial alignment prior on the device of its inputs. (The port's
cached F0 tracks, YIN and unvoiced-distance options are not copied: no
configuration of the benchmark takes them.)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from portbench.reference.frozen.data.pitch import pyin_f0
from portbench.reference.frozen.ops.priors import beta_binomial_prior
from portbench.reference.frozen.ops.stft import MelSpectrogram


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def collate_host(items: Sequence[Optional[Dict[str, Any]]],
                 hop_length: int = 256, audio_frames_multiple: int = 64,
                 text_multiple: int = 16,
                 pad_to: Optional[tuple] = None
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Pad dataset items into bucketed numpy arrays. None items (broken
    audio) are dropped. ``pad_to=(mel_frames, text_tokens)`` pins the
    padded shape, clipping longer items; otherwise the audio is padded so
    the mel frames land on a multiple of ``audio_frames_multiple`` and the
    text on a multiple of ``text_multiple``."""
    items = [x for x in items if x is not None]
    if not items:
        return None
    B = len(items)
    audio_lens = np.array([len(x["audio"]) for x in items], np.int32)
    text_lens = np.array([len(x["text_encoded"]) for x in items], np.int32)

    if pad_to is not None:
        max_frames, T_text = int(pad_to[0]), int(pad_to[1])
        T_audio = max_frames * hop_length
        audio_lens = np.minimum(audio_lens, T_audio)
        text_lens = np.minimum(text_lens, T_text)
    else:
        max_frames = round_up(1 + int(audio_lens.max()) // hop_length,
                              audio_frames_multiple)
        T_audio = max_frames * hop_length
        T_text = round_up(int(text_lens.max()), text_multiple)

    audio = np.zeros((B, T_audio), np.float32)
    text = np.zeros((B, T_text), np.int32)
    for i, x in enumerate(items):
        audio[i, :audio_lens[i]] = x["audio"][:audio_lens[i]]
        text[i, :text_lens[i]] = x["text_encoded"][:text_lens[i]]

    return {
        "audio": audio,
        "audio_lengths": audio_lens,
        "text": text,
        "input_lengths": text_lens,
        "speaker_ids": np.array([x["speaker_id"] for x in items], np.int32),
        "accent_ids": np.array([x["accent_id"] for x in items], np.int32),
        "speaker_f0_mean": np.array(
            [x["speaker_f0_mean"] for x in items], np.float32),
        "speaker_f0_std": np.array(
            [x["speaker_f0_std"] for x in items], np.float32),
        "speaker_energy_mean": np.array(
            [x["speaker_energy_mean"] for x in items], np.float32),
        "speaker_energy_std": np.array(
            [x["speaker_energy_std"] for x in items], np.float32),
        "audiopaths": [x["audiopath"] for x in items],
        "text_raw": [x["text_raw"] for x in items],
        "language": [x["language"] for x in items],
        "idx": np.array([x["idx"] for x in items], np.int32),
    }


class Featurizer:
    """Batched feature extraction -> a training-step batch, on the device
    of ``featurize_raw``'s inputs."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, f0_min=80.0, f0_max=640.0,
                 use_log_f0=True, use_scaled_energy=True,
                 use_attn_prior_masking=True,
                 betabinom_scaling_factor=0.05,
                 mel_noise_scale=0.0, distance_tx_unvoiced=False,
                 f0_method="pyin", seed=0):
        self.mel = MelSpectrogram(filter_length, hop_length, win_length,
                                  n_mel_channels, sampling_rate, mel_fmin,
                                  mel_fmax)
        self.hop_length = hop_length
        self.filter_length = filter_length
        self.sampling_rate = sampling_rate
        self.f0_min, self.f0_max = f0_min, f0_max
        self.use_log_f0 = use_log_f0
        self.use_scaled_energy = use_scaled_energy
        self.use_attn_prior_masking = use_attn_prior_masking
        self.betabinom_scaling_factor = betabinom_scaling_factor
        if distance_tx_unvoiced or f0_method != "pyin":
            raise ValueError("only pYIN F0 without the unvoiced-distance "
                             "transform is copied")
        if mel_noise_scale:
            raise ValueError("the mel noise is not copied: every "
                             "configuration of the benchmark sets it 0")

    def _featurize(self, audio, audio_lens, text_lens, max_text: int):
        hop = self.hop_length
        # drop the +1 frame so the mel frames equal the bucket multiple
        mel = self.mel(audio)[:, :audio.shape[1] // hop]
        n = mel.shape[1]
        mel_lens = torch.clamp(1 + audio_lens // hop, max=n).to(torch.int32)

        f0, voiced, p_voiced = (t[:, :n] for t in pyin_f0(
            audio, sampling_rate=self.sampling_rate,
            frame_length=self.filter_length, hop_length=hop,
            f0_min=self.f0_min, f0_max=self.f0_max))
        if self.use_log_f0:
            f0 = torch.where(f0 >= self.f0_min,
                             torch.log(torch.clamp_min(f0, 1.0)), 0.0)

        energy = mel.mean(dim=-1)
        if self.use_scaled_energy:
            energy = (energy + 20.0) / 20.0

        frame_mask = (torch.arange(n, device=mel.device)[None, :]
                      < mel_lens[:, None]).to(mel.dtype)
        mel = mel * frame_mask[..., None]
        f0, voiced, energy = (t * frame_mask for t in (f0, voiced, energy))

        if self.use_attn_prior_masking:
            prior = beta_binomial_prior(
                text_lens, mel_lens, max_text=max_text, max_mel=n,
                scaling_factor=self.betabinom_scaling_factor)
        else:
            prior = torch.ones((audio.shape[0], n, max_text),
                               device=mel.device)
        return mel, mel_lens, f0, voiced, p_voiced, energy, prior

    def featurize_raw(self, raw: Dict[str, torch.Tensor],
                      noise_key: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """``raw_arrays`` as tensors on one device -> the training-step
        batch on that device (``noise_key`` is taken and unused: the mel
        noise is 0)."""
        audio = raw["audio_i16"].to(torch.float32) / 32768.0
        mel, mel_lens, f0, voiced, p_voiced, energy, prior = self._featurize(
            audio, raw["audio_lengths"], raw["input_lengths"],
            int(raw["text"].shape[1]))
        batch = {k: v for k, v in raw.items() if k != "audio_i16"}
        batch["audio"] = audio
        batch.update(mel=mel, output_lengths=mel_lens, f0=f0,
                     voiced_mask=voiced, p_voiced=p_voiced,
                     energy_avg=energy, attn_prior=prior)
        return batch
