"""Text encoder: conv bank + BiLSTM.

Counterpart of ``radmmm_tpu/models/encoder.py``: three partial-padded,
weight-normed convs each followed by masked instance norm and relu, then a
BiLSTM (spectral norm on its recurrent weights when configured). In
training (``train=True``) each conv block ends in dropout drawn from the
caller's generator and the spectral norms update their ``u``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference.frozen.ops.conv import MaskedConv1d, dropout
from portbench.reference.frozen.ops.lstm import MaskedLSTM
from portbench.reference.frozen.ops.norms import MaskedInstanceNorm1d


class TextEncoder(nn.Module):
    def __init__(self, encoder_n_convolutions: int = 3,
                 encoder_embedding_dim: int = 512,
                 encoder_kernel_size: int = 5,
                 lstm_norm_fn: Optional[str] = None, p_dropout: float = 0.5):
        super().__init__()
        self.n_convs = encoder_n_convolutions
        self.p_dropout = p_dropout
        e = encoder_embedding_dim
        for i in range(encoder_n_convolutions):
            setattr(self, f"conv_{i}", MaskedConv1d(
                e, e, encoder_kernel_size, w_init_gain="relu",
                use_partial_padding=True, use_weight_norm=True))
            setattr(self, f"norm_{i}", MaskedInstanceNorm1d(e))
        self.lstm = MaskedLSTM(e, e // 2, bidirectional=True,
                               spectral_norm=(lstm_norm_fn == "spectral"))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T_text, C) embedded text (+accent). Returns (B, T, C).
        ``generator`` draws the dropout masks (training only)."""
        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x, mask)
            x = torch.relu(getattr(self, f"norm_{i}")(x, mask))
            x = dropout(x, self.p_dropout, generator if train else None)
        return self.lstm(x, mask, update_sn=train)
