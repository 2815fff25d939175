"""Masked 1-D convolutions, channels-last at the boundary, with weight norm
and partial padding.

Counterpart of ``radmmm_tpu/ops/conv.py``. Inputs are (B, T, C); weights are
stored in PyTorch's (C_out, C_in, K) layout and the convolution itself is
``F.conv1d`` on a (B, C, T) view. Behaviour kept from the JAX module:

* weight norm per output channel: kernel = v * g / max(||v||, 1e-12);
* partial padding: outputs are renormalised by K / (conv(mask) + 1e-6),
  the ratio and the bias are multiplied by the clipped update mask;
* ``premask_input=False`` convolves the unmasked input (the DAP bottleneck
  reads the padded frame beyond the last valid one);
* the output is re-zeroed at masked frames whenever a mask is given.

Every product runs in float32 (the port's bf16 switch is not copied:
each configuration of the benchmark states f32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def conv1d(x_bct: torch.Tensor, w: torch.Tensor, padding: int = 0,
           dilation: int = 1, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """(B, C_in, T) x (C_out, C_in, K) -> (B, C_out, T'), zero padding (the
    JAX package's ``conv1d_same``)."""
    return F.conv1d(x_bct, w, bias, padding=padding, dilation=dilation)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (the JAX package's einsums at f32): x (..., K) with w (K, P),
    or x (N, M, K) with w (N, K, P)."""
    return torch.matmul(x, w)


def calculate_gain(nonlinearity: str) -> float:
    gains = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3}
    return gains[nonlinearity]


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor, dim: int = 0):
    """v * g / max(||v||, 1e-12), the norm taken over every axis but
    ``dim`` (dim 0: per output channel of a (C_out, C_in, K) conv)."""
    axes = [a for a in range(v.dim()) if a != dim]
    norm = torch.linalg.vector_norm(v, dim=axes, keepdim=True)
    shape = [1] * v.dim()
    shape[dim] = -1
    return v * (g.reshape(shape) / norm.clamp_min(1e-12))


class MaskedConv1d(nn.Module):
    """ConvNorm equivalent: optional weight norm, partial padding, mask
    re-zero. ``mask`` is (B, T) (float or bool) or None."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, use_bias: bool = True,
                 use_partial_padding: bool = False,
                 use_weight_norm: bool = False, w_init_gain: str = "linear",
                 padding: Optional[int] = None, zero_init: bool = False,
                 premask_input: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.padding = (dilation * (kernel_size - 1) // 2
                        if padding is None else padding)
        self.use_partial_padding = use_partial_padding
        self.use_weight_norm = use_weight_norm
        self.premask_input = premask_input
        w = torch.empty(features, in_channels, kernel_size)
        if zero_init:
            nn.init.zeros_(w)
        else:
            fan_in, fan_out = in_channels * kernel_size, features * kernel_size
            bound = calculate_gain(w_init_gain) * math.sqrt(
                6.0 / (fan_in + fan_out))
            nn.init.uniform_(w, -bound, bound)
        if use_weight_norm:
            self.v = nn.Parameter(w)
            self.g = nn.Parameter(
                torch.linalg.vector_norm(w, dim=(1, 2)).clone())
        else:
            self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        if self.use_weight_norm:
            return weight_norm_kernel(self.v, self.g)
        return self.weight

    def _conv(self, x_bct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return conv1d(x_bct, w, self.padding, self.dilation)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        fmask = None
        if mask is not None:
            fmask = mask.to(x.dtype)[..., None]                  # (B, T, 1)
            if self.premask_input or self.use_partial_padding:
                x = x * fmask
        raw = self._conv(x.transpose(1, 2), self.kernel()).transpose(1, 2)

        if self.use_partial_padding:
            m = (fmask if fmask is not None
                 else x.new_ones((1, x.shape[1], 1)))
            ones = x.new_ones((1, 1, self.kernel_size))
            update_mask = self._conv(m.transpose(1, 2), ones).transpose(1, 2)
            mask_ratio = self.kernel_size / (update_mask + 1e-6)
            update_mask = update_mask.clamp(0.0, 1.0)
            mask_ratio = mask_ratio * update_mask
            out = raw * mask_ratio
            if self.bias is not None:
                out = out + self.bias * update_mask
        else:
            out = raw if self.bias is None else raw + self.bias

        if fmask is not None:
            out = out * fmask
        return out


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a Bernoulli mask drawn from ``generator`` (the
    caller's explicit stream, where the JAX package passes its dropout
    key); identity when ``generator`` is None or ``p`` is 0."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Linear(nn.Module):
    """LinearNorm equivalent: xavier-uniform weight (C_out, C_in), torch's
    default bias init."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 w_init_gain: str = "linear"):
        super().__init__()
        bound = calculate_gain(w_init_gain) * math.sqrt(
            6.0 / (in_features + features))
        self.weight = nn.Parameter(
            torch.empty(features, in_features).uniform_(-bound, bound))
        b_bound = 1.0 / math.sqrt(in_features)
        self.bias = (nn.Parameter(torch.empty(features).uniform_(-b_bound,
                                                                 b_bound))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
