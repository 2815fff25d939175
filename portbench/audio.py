"""Seeded voiced audio, so that pYIN has pitch to track: a frozen copy of
``chip_smoke.py``'s ``_voiced_wav`` (a three-harmonic tone with 5 Hz
vibrato, an unvoiced noise burst after every 0.9 s of tone), and the
dataset items the port's ``collate_host`` takes."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def voiced_wav(n: int, f0: float, rng, sr: int) -> np.ndarray:
    """n samples of int16 voiced audio at ``sr``."""
    t = np.arange(n) / sr
    phase = 2 * np.pi * f0 * t + f0 * 0.03 / 5.0 * np.sin(2 * np.pi * 5 * t)
    x = (0.4 * np.sin(phase) + 0.25 * np.sin(2 * phase)
         + 0.12 * np.sin(3 * phase))
    burst = (t % 1.0) >= 0.9
    x[burst] = 0.05 * rng.standard_normal(int(burst.sum()))
    return np.clip(np.rint(x * 32767 * 0.8), -32768, 32767).astype(np.int16)


def item(rng, n_samples: int, n_tokens: int, n_text_tokens: int,
         speaker: int, accent: int, sr: int, idx: int) -> Dict[str, Any]:
    """One utterance as a dataset item: voiced audio of ``n_samples`` at
    a pitch drawn from 110-250 Hz, ``n_tokens`` random token ids (0 is
    the padding id, so ids start at 1)."""
    f0 = float(rng.uniform(110.0, 250.0))
    audio = voiced_wav(n_samples, f0, rng, sr).astype(np.float32) / 32768.0
    return {"audio": audio,
            "text_encoded": rng.integers(1, n_text_tokens, n_tokens),
            "speaker_id": int(speaker), "accent_id": int(accent),
            "speaker_f0_mean": float(np.log(f0)), "speaker_f0_std": 0.25,
            "speaker_energy_mean": 0.5, "speaker_energy_std": 0.15,
            "audiopath": f"synthetic_{idx}.wav", "text_raw": "synthetic",
            "language": "en_US", "idx": idx}
