"""Masked instance norm with length masks (the port's
``ops/norms.MaskedInstanceNorm1d``). Layout (B, T, C); the mask is (B, T).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedInstanceNorm1d(nn.Module):
    """Affine instance norm over valid frames: biased variance
    E[x·x] - mean², eps 1e-5 as torch's InstanceNorm1d."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = (x.new_ones(x.shape[:2]) if mask is None else mask.to(x.dtype))
        n = m.sum(dim=1).clamp_min(1.0)[:, None]              # (B, 1)
        xm = x * m[..., None]
        mean = xm.sum(dim=1) / n                              # (B, C)
        var = (xm * x).sum(dim=1) / n - mean ** 2
        out = (x - mean[:, None, :]) * torch.rsqrt(var[:, None, :] + self.eps)
        out = out * self.scale + self.bias
        if mask is not None:
            out = out * m[..., None]
        return out
