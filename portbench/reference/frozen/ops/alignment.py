"""Monotonic alignment search (MAS) in plain PyTorch: a frozen copy of the
port's twin of its MAS kernel (``ops/alignment.py``). Width-1 monotonic:
each mel frame attends one text token; the token index is non-decreasing
and advances by at most 1 per frame. Ties prefer the diagonal, and row 0
also marks token 0.
"""
from __future__ import annotations

import torch


NEG_INF = -1e30

def _log_attention(attn_map: torch.Tensor, text_lens: torch.Tensor):
    """log(max(attn, 1e-45)) on valid text columns, NEG_INF elsewhere, and
    only token 0 reachable at row 0."""
    T_text = attn_map.shape[2]
    j = torch.arange(T_text, device=attn_map.device)
    text_valid = j[None, :] < text_lens[:, None]                # (B, Tt)
    log_attn = torch.where(text_valid[:, None, :],
                           torch.log(attn_map.clamp_min(1e-45)), NEG_INF)
    row0 = torch.where(j[None, :] == 0, log_attn[:, 0, :], NEG_INF)
    return torch.cat([row0[:, None, :], log_attn[:, 1:]], dim=1)


def mas_width1_reference(log_attn: torch.Tensor, text_lens: torch.Tensor,
                         mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel, from the masked log attention: a loop over
    mel rows for the Viterbi DP, then one over rows for the backtrack (the
    JAX package's scan path, written in torch)."""
    B, T_mel, T_text = log_attn.shape
    dev = log_attn.device
    neg = log_attn.new_full((B, 1), NEG_INF)
    log_p = log_attn[:, 0]
    choices = []
    for i in range(1, T_mel):
        shifted = torch.cat([neg, log_p[:, :-1]], dim=1)
        diag = shifted >= log_p
        new = log_attn[:, i] + torch.where(diag, shifted, log_p)
        valid = (i < mel_lens)[:, None]
        log_p = torch.where(valid, new, log_p)
        choices.append(diag & valid)
    out = log_attn.new_zeros((B, T_mel, T_text))
    rows = torch.arange(B, device=dev)
    cur = (text_lens - 1).long().clamp_min(0)
    for i in range(T_mel - 1, 0, -1):
        valid = i < mel_lens
        out[rows, i, cur] = valid.to(out.dtype)
        took = choices[i - 1][rows, cur]
        # an item with no text ties at column 0 (NEG_INF >= NEG_INF); it is
        # masked to zero below, and cur stays in range
        cur = cur - (took & valid & (cur > 0)).long()
    out[rows, 0, cur] = 1.0
    out[:, 0, 0] = 1.0
    j = torch.arange(T_text, device=dev)
    keep = ((j[None, None, :] < text_lens[:, None, None])
            & (torch.arange(T_mel, device=dev)[None, :, None]
               < mel_lens[:, None, None]))
    return out * keep.to(out.dtype)


def _check(attn_map, text_lens, mel_lens):
    if attn_map.dim() != 3 or attn_map.dtype != torch.float32:
        raise TypeError("mas_width1: attn_map must be (B, T_mel, T_text) "
                        f"float32, got {tuple(attn_map.shape)} "
                        f"{attn_map.dtype}")
    B = attn_map.shape[0]
    for name, t in (("text_lens", text_lens), ("mel_lens", mel_lens)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise TypeError(f"mas_width1: {name} must be ({B},) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mas_width1: {name} must be contiguous")
        if t.device != attn_map.device:
            raise ValueError(f"mas_width1: {name} is on {t.device}, attn_map "
                             f"on {attn_map.device}")
    if attn_map.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"mas_width1: no kernel for device "
                           f"{attn_map.device}")


def mas_width1(attn_map: torch.Tensor, text_lens: torch.Tensor,
               mel_lens: torch.Tensor) -> torch.Tensor:
    """Batched width-1 MAS. attn_map (B, T_mel, T_text) soft attention
    (>= 0); text_lens, mel_lens (B,) int32 with text_lens <= T_text.
    Returns the hard alignment (B, T_mel, T_text) in {0, 1}, zero outside
    the valid region and for items with no text or no frames."""
    _check(attn_map, text_lens, mel_lens)
    log_attn = _log_attention(attn_map, text_lens).contiguous()
    return mas_width1_reference(log_attn, text_lens, mel_lens)


def binarize_attention(attn_soft: torch.Tensor, text_lens: torch.Tensor,
                       mel_lens: torch.Tensor) -> torch.Tensor:
    """Hard MAS alignment, detached (the reference binarizes under no_grad
    and trains on the detached hard attention)."""
    with torch.no_grad():
        return mas_width1(attn_soft.detach(), text_lens.to(torch.int32),
                          mel_lens.to(torch.int32))
