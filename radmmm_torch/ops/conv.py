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

The precision switch (``set_conv_precision``, ``get_conv_precision``, the
environment variable ``RADMMM_CONV_PRECISION=bf16`` read at import) is
the JAX module's: process-wide, "f32" by default. In "bf16" mode every
convolution of ``conv1d`` (each ``MaskedConv1d``, the tensor-parallel
``end`` partial product and WaveGlow's unmasked convs) casts both operands
to bf16 and produces bf16 (cuDNN accumulates in f32), then upcasts to f32;
``matmul`` (the LSTM input projections) takes bf16-rounded operands with
f32 accumulation and an f32 result. The f32 parameters stay the master
copy. ``RADMMM_BF16_CAST=0`` (read at import) keeps bf16 mode but drops the
cast: the convolutions then take bf16-rounded operands and give an f32
output, forward and backward, which is what ``Precision.DEFAULT`` without
the cast computes on a TPU.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


_PRECISION = ("bf16" if os.environ.get("RADMMM_CONV_PRECISION") == "bf16"
              else "f32")
_BF16_CAST = os.environ.get("RADMMM_BF16_CAST", "1") != "0"


def set_conv_precision(precision: str) -> None:
    """'bf16' | 'f32' (anything but 'bf16' is f32), for every later call."""
    global _PRECISION
    _PRECISION = "bf16" if precision == "bf16" else "f32"


def get_conv_precision() -> str:
    return _PRECISION


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundedConv1d(torch.autograd.Function):
    """conv1d of bf16-rounded operands with an f32 output; its backward
    rounds the output gradient and the other operand the same way."""

    @staticmethod
    def forward(ctx, x, w, padding, dilation):
        x, w = bf16_round(x), bf16_round(w)
        ctx.save_for_backward(x, w)
        ctx.conf = (padding, dilation)
        return F.conv1d(x, w, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        padding, dilation = ctx.conf
        dy = bf16_round(dy)
        dx = torch.nn.grad.conv1d_input(x.shape, w, dy, padding=padding,
                                        dilation=dilation)
        dw = torch.nn.grad.conv1d_weight(x, w.shape, dy, padding=padding,
                                         dilation=dilation)
        return dx, dw, None, None


def conv1d(x_bct: torch.Tensor, w: torch.Tensor, padding: int = 0,
           dilation: int = 1, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """(B, C_in, T) x (C_out, C_in, K) -> (B, C_out, T'), zero padding, at
    the conv precision (the JAX package's ``conv1d_same``); ``bias`` is
    added in f32, after the upcast in bf16 mode."""
    if _PRECISION == "f32":
        return F.conv1d(x_bct, w, bias, padding=padding, dilation=dilation)
    if not _BF16_CAST:
        out = _RoundedConv1d.apply(x_bct, w, padding, dilation)
    else:
        out = F.conv1d(x_bct.to(torch.bfloat16), w.to(torch.bfloat16),
                       padding=padding, dilation=dilation).to(x_bct.dtype)
    return out if bias is None else out + bias[:, None]


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16-rounded operands, accumulated and returned in f32; a
    is (M, K) or (N, M, K), b (K, P) or (N, K, P). On the card, PyTorch's
    bf16 product with an f32 output where the installed build has one
    (``out_dtype``); otherwise, and on the CPU, the f32 product of the
    rounded operands, which gives the same values (each product of two
    bf16 numbers is exact in f32)."""
    if a.is_cuda and "dtype" in torch.ops.aten.mm.overloads():
        op = torch.mm if a.dim() == 2 else torch.bmm
        return op(a.to(torch.bfloat16), b.to(torch.bfloat16),
                  out_dtype=torch.float32)
    return torch.matmul(bf16_round(a), bf16_round(b))


class _Bf16Matmul(torch.autograd.Function):
    """x @ w with bf16-rounded operands and an f32 result, for x (..., K)
    and w (K, P), or x (N, M, K) and w (N, K, P); the backward's two
    products (the transposed dots JAX takes at the same precision) round
    their operands the same way."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if w.dim() == 2:
            return bf16_product(x.reshape(-1, x.shape[-1]), w).view(
                *x.shape[:-1], w.shape[-1])
        return bf16_product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if w.dim() == 2:
            x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])
            return (bf16_product(dy2, w.t()).view(x.shape),
                    bf16_product(x2.t(), dy2))
        return (bf16_product(dy, w.transpose(1, 2)),
                bf16_product(x.transpose(1, 2), dy))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w at the conv precision (the JAX package's einsums at
    ``get_conv_precision()``): ``torch.matmul`` in f32 mode; in bf16 mode
    bf16-rounded operands, f32 accumulation and an f32 result, forward and
    backward. x (..., K) with w (K, P), or x (N, M, K) with w (N, K, P)."""
    if _PRECISION == "f32":
        return torch.matmul(x, w)
    return _Bf16Matmul.apply(x, w)


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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return masked_conv1d(x, self.kernel(), self.bias, mask, self.padding,
                             self.dilation, self.use_partial_padding,
                             self.premask_input)


def masked_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                  padding: int, dilation: int, use_partial_padding: bool,
                  premask_input: bool) -> torch.Tensor:
    """``MaskedConv1d``'s arithmetic: x (B, T, C_in), w (C_out, C_in, K),
    mask (B, T) or None -> (B, T', C_out), the convolution at the conv
    precision."""
    kernel_size = w.shape[2]
    fmask = None
    if mask is not None:
        fmask = mask.to(x.dtype)[..., None]                      # (B, T, 1)
        if premask_input or use_partial_padding:
            x = x * fmask
    raw = conv1d(x.transpose(1, 2), w, padding, dilation).transpose(1, 2)

    if use_partial_padding:
        m = (fmask if fmask is not None
             else x.new_ones((1, x.shape[1], 1)))
        ones = x.new_ones((1, 1, kernel_size))
        update_mask = conv1d(m.transpose(1, 2), ones, padding,
                             dilation).transpose(1, 2)
        mask_ratio = kernel_size / (update_mask + 1e-6)
        update_mask = update_mask.clamp(0.0, 1.0)
        mask_ratio = mask_ratio * update_mask
        out = raw * mask_ratio
        if bias is not None:
            out = out + bias * update_mask
    else:
        out = raw if bias is None else raw + bias

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
