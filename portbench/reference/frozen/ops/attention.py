"""Convolutional Gaussian alignment attention (ConvAttention).

Counterpart of ``radmmm_tpu/ops/attention.py``. The alignment runs in
training and in reconstruction, not on the serving path; the module is
here so that every parameter of a JAX ``TTSModel`` has its place in the
port's state_dict.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference.frozen.ops.conv import MaskedConv1d


class ConvAttention(nn.Module):
    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 512,
                 n_att_channels: int = 80):
        super().__init__()
        self.key_proj_0 = MaskedConv1d(n_text_channels, n_text_channels * 2,
                                       3, w_init_gain="relu",
                                       use_weight_norm=True)
        self.key_proj_1 = MaskedConv1d(n_text_channels * 2, n_att_channels,
                                       1, use_weight_norm=True)
        self.query_proj_0 = MaskedConv1d(n_mel_channels, n_mel_channels * 2,
                                         3, w_init_gain="relu",
                                         use_weight_norm=True)
        self.query_proj_1 = MaskedConv1d(n_mel_channels * 2, n_mel_channels,
                                         1, use_weight_norm=True)
        self.query_proj_2 = MaskedConv1d(n_mel_channels, n_att_channels, 1,
                                         use_weight_norm=True)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None):
        """queries (B, T_mel, n_mel); keys (B, T_text, n_text). Returns
        (attn softmaxed over text, attn_logprob), each (B, T_mel, T_text)."""
        temp = 0.0005
        k = self.key_proj_1(torch.relu(self.key_proj_0(keys)))
        q = torch.relu(self.query_proj_0(queries))
        q = torch.relu(self.query_proj_1(q))
        q = self.query_proj_2(q)
        q2 = (q * q).sum(-1)[:, :, None]
        k2 = (k * k).sum(-1)[:, None, :]
        attn = -temp * (q2 + k2 - 2.0 * torch.bmm(q, k.transpose(1, 2)))
        if attn_prior is not None:
            attn = torch.log_softmax(attn, dim=-1) + torch.log(
                attn_prior + 1e-8)
        attn_logprob = attn
        if key_mask is not None:
            attn = attn.masked_fill(~key_mask[:, None, :], float("-inf"))
        return torch.softmax(attn, dim=-1), attn_logprob
