"""Beta-binomial text/mel alignment prior, in closed form on the device.

Counterpart of ``radmmm_tpu/ops/priors.py``. Row i (1-indexed over the
valid mel frames) of an item's prior is BetaBinom(P - 1, s i, s (M + 1 - i))
over k in [0, P), P the text length and M the mel length:

    P(k; n, a, b) = C(n, k) B(k + a, n - k + b) / B(a, b)

computed with ``torch.lgamma`` for the whole padded batch at once. Padded
rows and columns are zero.
"""
from __future__ import annotations

import torch


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def beta_binomial_log_pmf(k, n, a, b):
    log_comb = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                - torch.lgamma(n - k + 1))
    return log_comb + _betaln(k + a, n - k + b) - _betaln(a, b)


def beta_binomial_prior(text_len: torch.Tensor, mel_len: torch.Tensor,
                        max_text: int, max_mel: int,
                        scaling_factor: float = 0.05) -> torch.Tensor:
    """Batched prior matrices (B, max_mel, max_text) f32 on the device of
    ``text_len`` ((B,) or a scalar, then (max_mel, max_text)).

    The log-pmf is taken in float64: its lgamma terms reach a few hundred
    and cancel to a few units, so in f32 their rounding alone would move
    the prior by about 1e-4 relative."""
    text_len = torch.as_tensor(text_len)
    mel_len = torch.as_tensor(mel_len, device=text_len.device)
    squeeze = text_len.dim() == 0
    dev = text_len.device
    P = torch.atleast_1d(text_len).to(torch.float64)[:, None, None]
    M = torch.atleast_1d(mel_len).to(torch.float64)[:, None, None]
    k = torch.arange(max_text, dtype=torch.float64, device=dev)[None, None]
    i = torch.arange(1, max_mel + 1, dtype=torch.float64,
                     device=dev)[None, :, None]

    a = scaling_factor * i
    # b > 0 on padded rows (i > M) keeps lgamma finite; masked out below
    b = torch.clamp_min(scaling_factor * (M + 1.0 - i), scaling_factor)
    n = torch.clamp_min(P - 1.0, 0.0)
    prior = torch.exp(beta_binomial_log_pmf(torch.minimum(k, n), n, a, b))
    prior = torch.where((i <= M) & (k < P), prior, 0.0).to(torch.float32)
    return prior[0] if squeeze else prior
