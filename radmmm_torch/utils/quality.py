"""Objective quality regression metrics: MCD, F0 RMSE, voicing F1.

The reference's validation quality signal is human-in-TensorBoard (images +
audio, training_callbacks.py:36-210); nothing scalar survives a refactor
regression. These metrics close that gap (VERDICT r3 next #6): computed on
frame-aligned reconstruction/attribute outputs every validation pass and
written to metrics.jsonl, with thresholds enforced by
tests/test_quality_metrics.py (a subtly-broken flow inverse moves MCD by
orders of magnitude; a broken predictor moves F0 RMSE / voicing F1).

All functions are plain numpy over host arrays — they run once per
validation on one batch, off the training step. A copy owned by the port
of radmmm_tpu/utils/quality.py.
"""
from __future__ import annotations

import numpy as np


def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II basis (rows 0..n_out-1), as used for MFCC/MCEP."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float64)


def mel_cepstral_distortion(mel_ref: np.ndarray, mel_hat: np.ndarray,
                            lens: np.ndarray, n_coeffs: int = 13) -> float:
    """Frame-aligned MCD in dB between two log-mel spectrograms.

    mel_*: (B, T, n_mel) log-mels on the SAME frame grid (the
    reconstruction path keeps ground-truth durations, so no DTW is needed).
    Cepstra are the DCT of the log-mel frame; c0 (overall energy) is
    excluded as is standard; MCD = (10/ln10)·sqrt(2·Σ_d (c_d − c'_d)²),
    averaged over valid frames.
    """
    mel_ref = np.asarray(mel_ref, np.float64)
    mel_hat = np.asarray(mel_hat, np.float64)
    lens = np.asarray(lens)
    dct = _dct_matrix(n_coeffs + 1, mel_ref.shape[-1])
    const = 10.0 / np.log(10.0) * np.sqrt(2.0)
    total, n_frames = 0.0, 0
    for b in range(mel_ref.shape[0]):
        L = int(lens[b])
        c_ref = mel_ref[b, :L] @ dct.T    # (L, n_coeffs+1)
        c_hat = mel_hat[b, :L] @ dct.T
        d = c_ref[:, 1:] - c_hat[:, 1:]   # drop c0
        total += const * np.sqrt((d ** 2).sum(-1)).sum()
        n_frames += L
    return float(total / max(n_frames, 1))


def f0_rmse(f0_ref: np.ndarray, f0_hat: np.ndarray,
            voiced_ref: np.ndarray, lens: np.ndarray) -> float:
    """RMSE between F0 tracks over frames that are voiced in the reference.

    Computed in whatever space the tracks are in (the model trains on
    normalized log-F0, so the value is scale-stable across speakers).
    """
    f0_ref, f0_hat = np.asarray(f0_ref), np.asarray(f0_hat)
    voiced_ref, lens = np.asarray(voiced_ref), np.asarray(lens)
    se, n = 0.0, 0
    for b in range(f0_ref.shape[0]):
        L = int(lens[b])
        m = voiced_ref[b, :L] > 0.5
        d = (f0_ref[b, :L][m] - f0_hat[b, :L][m]).astype(np.float64)
        se += float((d ** 2).sum())
        n += int(m.sum())
    return float(np.sqrt(se / max(n, 1)))


def voicing_f1(voiced_ref: np.ndarray, voiced_prob: np.ndarray,
               lens: np.ndarray, threshold: float = 0.5) -> float:
    """F1 of the voiced/unvoiced decision over valid frames."""
    voiced_ref = np.asarray(voiced_ref)
    voiced_prob = np.asarray(voiced_prob)
    lens = np.asarray(lens)
    tp = fp = fn = 0
    for b in range(voiced_ref.shape[0]):
        L = int(lens[b])
        ref = voiced_ref[b, :L] > 0.5
        hyp = voiced_prob[b, :L] > threshold
        tp += int((ref & hyp).sum())
        fp += int((~ref & hyp).sum())
        fn += int((ref & ~hyp).sum())
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 1.0


def reconstruction_quality(batch, rec_mel, outputs) -> dict:
    """The validation quality row: MCD between ground-truth and
    flow-reconstructed mel, plus attribute-prediction F0 RMSE and voicing
    F1 from the training-forward outputs (x vs x_hat are already in the
    predictor's normalized target space)."""
    lens = np.asarray(batch["output_lengths"])
    metrics = {
        "mcd_db": mel_cepstral_distortion(
            np.asarray(batch["mel"]), np.asarray(rec_mel), lens)}
    if "f0_outputs" in outputs:
        o = outputs["f0_outputs"]
        metrics["f0_rmse"] = f0_rmse(
            np.asarray(o["x"])[..., 0], np.asarray(o["x_hat"])[..., 0],
            np.asarray(batch["voiced_mask"]), lens)
    if "voiced_outputs" in outputs:
        o = outputs["voiced_outputs"]
        prob = 1.0 / (1.0 + np.exp(-np.asarray(o["x_hat"])[..., 0]))
        metrics["voicing_f1"] = voicing_f1(
            np.asarray(o["x"])[..., 0], prob, lens)
    return metrics
