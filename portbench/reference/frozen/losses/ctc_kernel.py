"""The CTC alpha and beta band DPs in plain PyTorch: a frozen copy of
the port's twins of its CTC kernels (``losses/ctc_kernel.py``). With S =
2*T_text + 1 states (even: blank, odd: text token (s+1)/2) and per-state
emissions ``emit_all`` (B, T_mel, S): ``ctc_alpha`` returns every row of
the forward DP (T_mel, B, S), rows frozen past each item's mel length;
``ctc_beta`` every row of the reverse DP. NEG_INF is the finite -1e30.
"""
from __future__ import annotations

import torch


NEG_INF = -1e30


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _skip(S: int, device) -> torch.Tensor:
    """0 into (alpha) / out of (beta) odd label states, NEG_INF for even."""
    s = torch.arange(S, device=device)
    return torch.where(s % 2 == 1, 0.0, NEG_INF)


def ctc_alpha_reference(emit_all: torch.Tensor, text_lens: torch.Tensor,
                        mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the alpha kernel: a loop over mel rows."""
    B, T, S = emit_all.shape
    s = torch.arange(S, device=emit_all.device)
    state_valid = s[None, :] <= 2 * text_lens[:, None]
    alpha = torch.where((s[None, :] <= 1) & state_valid, emit_all[:, 0],
                        NEG_INF)
    skip = _skip(S, emit_all.device)
    neg = emit_all.new_full((B, 1), NEG_INF)
    neg2 = emit_all.new_full((B, 2), NEG_INF)
    out = [alpha]
    for t in range(1, T):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1) + skip
        new = torch.where(state_valid,
                          _lse3(alpha, prev1, prev2) + emit_all[:, t],
                          NEG_INF)
        alpha = torch.where((t < mel_lens)[:, None], new, alpha)
        out.append(alpha)
    return torch.stack(out)


def ctc_beta_reference(emit_all: torch.Tensor, text_lens: torch.Tensor,
                       mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the beta kernel: a reverse loop over mel rows."""
    B, T, S = emit_all.shape
    s = torch.arange(S, device=emit_all.device)
    terminal = torch.where((s[None, :] == 2 * text_lens[:, None])
                           | (s[None, :] == 2 * text_lens[:, None] - 1),
                           0.0, NEG_INF)
    skip = _skip(S, emit_all.device)
    neg = emit_all.new_full((B, 1), NEG_INF)
    neg2 = emit_all.new_full((B, 2), NEG_INF)
    beta = terminal
    out = [beta]
    for t in range(T - 2, -1, -1):
        q = beta + emit_all[:, t + 1]
        n1 = torch.cat([q[:, 1:], neg], dim=1)
        n2 = torch.cat([q[:, 2:], neg2], dim=1) + skip
        beta = torch.where((t >= mel_lens - 1)[:, None], terminal,
                           _lse3(q, n1, n2))
        out.append(beta)
    return torch.stack(out[::-1])


def _check(emit_all, text_lens, mel_lens):
    if emit_all.dim() != 3 or emit_all.dtype != torch.float32:
        raise TypeError("ctc DP: emit_all must be (B, T_mel, S) float32, "
                        f"got {tuple(emit_all.shape)} {emit_all.dtype}")
    B = emit_all.shape[0]
    for name, t in (("text_lens", text_lens), ("mel_lens", mel_lens)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise TypeError(f"ctc DP: {name} must be ({B},) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ctc DP: {name} must be contiguous")
        if t.device != emit_all.device:
            raise ValueError(f"ctc DP: {name} is on {t.device}, emit_all "
                             f"on {emit_all.device}")
    if not emit_all.is_contiguous():
        raise ValueError("ctc DP: emit_all must be contiguous")


def ctc_alpha(emit_all: torch.Tensor, text_lens: torch.Tensor,
              mel_lens: torch.Tensor) -> torch.Tensor:
    """Every row of the forward DP, (T_mel, B, S). text_lens and mel_lens
    are (B,) int32 on emit_all's device."""
    _check(emit_all, text_lens, mel_lens)
    return ctc_alpha_reference(emit_all, text_lens, mel_lens)


def ctc_beta(emit_all: torch.Tensor, text_lens: torch.Tensor,
             mel_lens: torch.Tensor) -> torch.Tensor:
    """Every row of the reverse DP, (T_mel, B, S)."""
    _check(emit_all, text_lens, mel_lens)
    return ctc_beta_reference(emit_all, text_lens, mel_lens)
