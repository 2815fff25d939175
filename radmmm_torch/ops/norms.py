"""Masked normalization: instance norm and batch norm with length masks.

Counterpart of ``radmmm_tpu/ops/norms.py`` (``MaskedInstanceNorm1d``,
``MaskedBatchNorm``). Layout (B, T, C); the mask is (B, T).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from radmmm_torch.parallel import mesh


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


class MaskedBatchNorm(nn.Module):
    """Length-masked batch norm with running statistics.

    Train: normalise with the masked batch statistics (biased variance)
    and move the running mean toward the batch mean and the running
    variance toward the unbiased one, var * n / max(n - 1, 1), with
    momentum 0.1 as torch's BatchNorm1d. Eval: normalise with the running
    statistics. ``scale`` and ``bias`` are parameters; ``mean`` and
    ``var`` are buffers (the JAX module's ``batch_stats`` collection).
    The padded frames are normalised too, as in the JAX module.

    Under a data mesh (``parallel.mesh``) the statistics are the global
    batch's: (sum x, sum x², n) are summed over the data group, with their
    gradient, whatever ``sync`` says. In the JAX package the step is one
    program over the global batch, so its statistics are global whether
    or not ``sync`` binds an axis; ``sync`` is accepted and changes
    nothing."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = True, sync: bool = False) -> torch.Tensor:
        del sync
        if train:
            m = (x.new_ones(x.shape[:2]) if mask is None
                 else mask.to(x.dtype))
            n = m.sum()
            sum_x = torch.einsum("btc,bt->c", x, m)
            sum_xsq = torch.einsum("btc,bt->c", x * x, m)
            if mesh.n_data() > 1:
                sum_x, sum_xsq, n = mesh.data_all_reduce(
                    torch.cat([sum_x, sum_xsq, n[None]])).split(
                        [len(sum_x), len(sum_x), 1])
                n = n[0]
            mean = sum_x / n
            var = sum_xsq / n - mean ** 2
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.mean.copy_(self.momentum * mean
                                + (1 - self.momentum) * self.mean)
                self.var.copy_(self.momentum * unbiased
                               + (1 - self.momentum) * self.var)
        else:
            mean, var = self.mean, self.var
        out = (x - mean) * torch.rsqrt(var + self.eps)
        return out * self.scale + self.bias
