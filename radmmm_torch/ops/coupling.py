"""Coupling layers of the flow and their parameter predictors.

Counterpart of ``radmmm_tpu/ops/coupling.py``: ``WN``, ``SimpleConvNet``,
``FiLMResBlock``, ``FiLMStack``, ``scaling_and_logs``, ``AffineCoupling``
(with a WaveNet, simple-conv or FiLM-stack predictor), ``SplineCoupling``
and ``SplineCouplingAR``. The forward (training) direction returns the
coupled z and log s, the inverse (sampling) direction undoes it. Where
the JAX module convolves without a mask (the WN ``start``, ``res_skip``
and ``end``, the simple conv net's ``last``, the FiLM stack's ``end``),
so does this one. ``train`` picks the batch norms' batch statistics
(True, updating their running statistics) or their running ones.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from radmmm_torch.ops import splines as S
from radmmm_torch.ops import wn_conv
from radmmm_torch.parallel import collectives as C
from radmmm_torch.ops.conv import MaskedConv1d, conv1d
from radmmm_torch.ops.norms import MaskedBatchNorm


class WN(nn.Module):
    """(z_half (B,T,C_half), context (B,T,C_ctx)) -> (B, T, 2*C_half).

    Tensor-parallel once ``parallel.mesh.shard_state`` has split it over a
    model group (``tp``): ``start``, ``in_i`` and ``res_skip_i`` hold a
    slice of the hidden channels (column-parallel), h is gathered after
    ``start`` and after each ``in_i`` (one gather a layer, read by both
    ``res_skip_i`` and ``in_{i+1}``), and ``end`` holds a slice of its
    input channels (row-parallel): its partial products are summed over
    the group, then the bias added. The stack's input is replicated, so
    its gradient is summed over the group. Its convolutions go through
    ``wn_conv.conv``: K7 on the card in f32 conv precision, the modules
    otherwise."""

    def __init__(self, n_in_channels: int, n_context_channels: int,
                 n_layers: int = 4, n_channels: int = 1024,
                 kernel_size: int = 5, affine_activation: str = "softplus",
                 use_partial_padding: bool = True, use_dilation: bool = True):
        super().__init__()
        self.n_layers = n_layers
        self.act = F.softplus if affine_activation == "softplus" else F.relu
        self.start = MaskedConv1d(n_in_channels + n_context_channels,
                                  n_channels, 1, use_weight_norm=True)
        for i in range(n_layers):
            dilation = 2 ** i if use_dilation else 1
            setattr(self, f"in_{i}", MaskedConv1d(
                n_channels, n_channels, kernel_size, dilation=dilation,
                use_partial_padding=use_partial_padding,
                use_weight_norm=True))
            setattr(self, f"res_skip_{i}", MaskedConv1d(
                n_channels, n_channels, 1, use_weight_norm=True))
        self.end = MaskedConv1d(n_channels, 2 * n_in_channels, 1,
                                zero_init=True)
        self.tp = None          # a collectives.Group once split

    def forward(self, z, context, mask=None):
        if self.tp is not None:
            return self._forward_split(z, context, mask)
        h = wn_conv.conv(self.start, torch.cat([z, context], dim=-1))
        output = torch.zeros_like(h)
        for i in range(self.n_layers):
            h = self.act(wn_conv.conv(getattr(self, f"in_{i}"), h, mask))
            output = output + self.act(
                wn_conv.conv(getattr(self, f"res_skip_{i}"), h))
        return wn_conv.conv(self.end, output)

    def _forward_split(self, z, context, mask):
        g = self.tp
        x = C.copy_to_group(torch.cat([z, context], dim=-1), g)
        h = C.gather(wn_conv.conv(self.start, x), g, dim=-1)
        output = 0.0
        for i in range(self.n_layers):
            h = C.gather(self.act(wn_conv.conv(getattr(self, f"in_{i}"), h,
                                               mask)), g, dim=-1)
            output = output + self.act(
                wn_conv.conv(getattr(self, f"res_skip_{i}"), h))
        partial = conv1d(output.transpose(1, 2),
                         self.end.kernel()).transpose(1, 2)
        return C.reduce_from_group(partial, g) + self.end.bias


class SimpleConvNet(nn.Module):
    """Dilated conv stack whose channels double (to at most
    ``max_channels``), relu after each, then a 1x1 head (zero at init)."""

    def __init__(self, in_channels: int, final_out_channels: int,
                 n_layers: int = 2, kernel_size: int = 5,
                 with_dilation: bool = True, max_channels: int = 1024,
                 zero_init: bool = True, use_partial_padding: bool = True):
        super().__init__()
        self.n_layers = n_layers
        c = in_channels
        for i in range(n_layers):
            out_ch = min(max_channels, c * 2)
            setattr(self, f"layer_{i}", MaskedConv1d(
                c, out_ch, kernel_size,
                dilation=2 ** i if with_dilation else 1, w_init_gain="relu",
                use_partial_padding=use_partial_padding))
            c = out_ch
        self.last = MaskedConv1d(c, final_out_channels, 1,
                                 zero_init=zero_init)

    def forward(self, x, mask=None):
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"layer_{i}")(x, mask))
        return self.last(x)


class FiLMResBlock(nn.Module):
    """FiLM-conditioned residual block: weight-normed input, cond and
    hidden convs, leaky relu 0.01, an optional batch norm and a 0.5
    residual."""

    def __init__(self, in_channels: int, cond_channels: int,
                 out_channels: int, kernel_size: int = 1, dilation: int = 1,
                 use_bn: bool = True, use_partial_padding: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.input_conv = MaskedConv1d(
            in_channels, out_channels, 1, use_weight_norm=True,
            use_partial_padding=use_partial_padding)
        self.cond_conv = MaskedConv1d(
            cond_channels, 2 * out_channels, 1, use_weight_norm=True,
            use_partial_padding=use_partial_padding)
        self.hidden_conv = MaskedConv1d(
            out_channels, out_channels, kernel_size, dilation=dilation,
            use_weight_norm=True, use_partial_padding=use_partial_padding)
        self.bn = MaskedBatchNorm(out_channels) if use_bn else None

    def forward(self, x, cond, mask=None, train: bool = True):
        x1 = self.input_conv(x, mask)
        c1 = self.cond_conv(cond, mask)
        scale = c1[..., :self.out_channels] + 1.0
        bias = c1[..., self.out_channels:]
        x1_res = F.leaky_relu(x1, 0.01)
        x2 = self.hidden_conv(x1_res, mask)
        if self.bn is not None:
            x2 = self.bn(x2, mask, train=train)
        x2 = F.leaky_relu(x2 * scale + bias, 0.01)
        return 0.5 * (x2 + x1_res)


class FiLMStack(nn.Module):
    """FiLM residual blocks with dilated kernels, then a 1x1 head (zero at
    init)."""

    def __init__(self, in_channels: int, cond_channels: int,
                 n_hidden_channels: int, n_out_channels: int, n_layers: int,
                 kernel_size: int = 5, use_dilation: bool = True,
                 use_bn: bool = True, use_partial_padding: bool = True):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"block_{i}", FiLMResBlock(
                in_channels if i == 0 else n_hidden_channels, cond_channels,
                n_hidden_channels, kernel_size,
                2 ** i if use_dilation else 1, use_bn, use_partial_padding))
        self.end = MaskedConv1d(n_hidden_channels, n_out_channels, 1,
                                zero_init=True)

    def forward(self, x, context, mask=None, train: bool = True):
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, context, mask, train)
        return self.end(x)


def scaling_and_logs(u: torch.Tensor,
                     scaling_fn: Union[str, Sequence[str]]):
    """Constrained scale and its log; 'tanh' (the shipped config) is
    s = tanh(u) + 1 + 1e-6."""
    def one(u, fn):
        if fn == "translate":
            return torch.ones_like(u), torch.zeros_like(u)
        if fn == "exp":
            return torch.exp(u), u
        if fn == "tanh":
            s = torch.tanh(u) + 1.0 + 1e-6
            return s, torch.log(s)
        if fn == "sigmoid":
            s = torch.sigmoid(u + 10.0) + 1e-6
            return s, torch.log(s)
        raise ValueError(f"unsupported scaling fn {fn}")

    if isinstance(scaling_fn, str):
        return one(u, scaling_fn)
    outs = [one(u[..., i:i + 1], fn) for i, fn in enumerate(scaling_fn)]
    return (torch.cat([s for s, _ in outs], dim=-1),
            torch.cat([l for _, l in outs], dim=-1))


class AffineCoupling(nn.Module):
    """Split-half affine coupling z1 <- s(z0, ctx) * z1 + b(z0, ctx); the
    parameters come from a WaveNet (``wavenet``), a simple conv net over
    [z0, ctx] (``simple_conv``) or a FiLM stack of 1024 channels without
    batch norm (``film_stack``)."""

    def __init__(self, n_mel_channels: int, n_context_channels: int,
                 n_layers: int, affine_model: str = "wavenet",
                 scaling_fn: Union[str, Sequence[str]] = "exp",
                 affine_activation: str = "softplus",
                 with_dilation: bool = True, kernel_size: int = 5,
                 n_channels: int = 1024, use_partial_padding: bool = False):
        super().__init__()
        self.n_half = n_mel_channels // 2
        self.scaling_fn = scaling_fn
        self.affine_model = affine_model
        if affine_model == "wavenet":
            # the JAX module leaves WN's dilation at its default whatever
            # with_dilation says; so does this one
            self.wn = WN(self.n_half, n_context_channels, n_layers,
                         n_channels, kernel_size, affine_activation,
                         use_partial_padding)
        elif affine_model == "simple_conv":
            self.scn = SimpleConvNet(
                self.n_half + n_context_channels, n_mel_channels, n_layers,
                kernel_size, with_dilation, zero_init=True,
                use_partial_padding=use_partial_padding)
        elif affine_model == "film_stack":
            self.film = FiLMStack(self.n_half, n_context_channels, 1024,
                                  n_mel_channels, n_layers, kernel_size,
                                  with_dilation, use_bn=False)
        else:
            raise ValueError(f"unknown affine model {affine_model}")

    def _params(self, z0, context, mask, train):
        if self.affine_model == "wavenet":
            params = self.wn(z0, context, mask)
        elif self.affine_model == "simple_conv":
            params = self.scn(torch.cat([z0, context], dim=-1), mask)
        else:
            params = self.film(z0, context, mask, train)
        s, log_s = scaling_and_logs(params[..., :self.n_half],
                                    self.scaling_fn)
        return s, log_s, params[..., self.n_half:]

    def forward(self, z, context, mask=None, train: bool = True):
        """(concat(z0, s * z1 + b), log s)."""
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        s, log_s, b = self._params(z0, context, mask, train)
        return torch.cat([z0, s * z1 + b], dim=-1), log_s

    def inverse(self, z, context, mask=None, train: bool = True):
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        s, _, b = self._params(z0, context, mask, train)
        return torch.cat([z0, (z1 - b) / s], dim=-1)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is float64: the splines run in
    float32 as in the JAX module, or wholly in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class SplineCoupling(nn.Module):
    """Split-half monotone-spline coupling from [left, right] to [bottom,
    top], its bin parameters from a FiLM stack of 512 channels over z0.
    The flow builds it quadratic with 32 bins and bounds ±3."""

    def __init__(self, n_mel_channels: int, n_context_channels: int,
                 n_layers: int, n_bins: int = 8, left: float = -4.0,
                 right: float = 4.0, bottom: float = -4.0, top: float = 4.0,
                 use_quadratic: bool = False, use_bn: bool = True,
                 kernel_size: int = 5, with_dilation: bool = True):
        super().__init__()
        self.n_half = n_mel_channels // 2
        self.n_bins = 2 * n_bins + 1 if use_quadratic else n_bins
        self.left, self.right, self.bottom, self.top = left, right, bottom, top
        self.use_quadratic = use_quadratic
        self.film = FiLMStack(self.n_half, n_context_channels, 512,
                              self.n_half * self.n_bins, n_layers,
                              kernel_size, with_dilation, use_bn)

    def _transform(self, z0, z1, context, mask, train, inverse):
        B, T = z1.shape[:2]
        params = self.film(z0, context, mask, train)
        q_tilde = params.reshape(B * T, self.n_half, self.n_bins)
        z1_flat = _at_least_f32(z1.reshape(B * T, self.n_half))
        log_s = None
        if self.use_quadratic:
            k = self.n_bins // 2
            z1_t, log_s = S.unbounded_piecewise_quadratic_transform(
                z1_flat, q_tilde[..., :k], q_tilde[..., k:], inverse=inverse)
            if not inverse:
                log_s = log_s.sum(dim=1)
        elif inverse:
            z1_t, _ = S.piecewise_linear_inverse_transform(z1_flat, q_tilde)
        else:
            z1_t, log_s = S.piecewise_linear_transform(z1_flat, q_tilde)
        return z1_t.reshape(B, T, self.n_half), log_s

    def forward(self, z, context, mask=None, train: bool = True):
        """(concat(z0, spline(z1)), log s (B, T, 1))."""
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        z1 = (z1 - self.left) / (self.right - self.left)
        z1, log_s = self._transform(z0, z1, context, mask, train, False)
        z1 = z1 * (self.top - self.bottom) + self.bottom
        B, T = z1.shape[:2]
        log_s = log_s.reshape(B, T, 1) + self.n_half * (
            math.log(self.top - self.bottom)
            - math.log(self.right - self.left))
        return torch.cat([z0, z1], dim=-1), log_s

    def inverse(self, z, context, mask=None, train: bool = True):
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        z1 = (z1 - self.bottom) / (self.top - self.bottom)
        z1, _ = self._transform(z0, z1, context, mask, train, True)
        z1 = z1 * (self.right - self.left) + self.left
        return torch.cat([z0, z1], dim=-1)


class SplineCouplingAR(nn.Module):
    """Autoregressive spline transform of every channel, its bin
    parameters from the context alone (a 1x1 simple conv net)."""

    def __init__(self, n_in_channels: int, n_context_channels: int,
                 n_layers: int, n_bins: int = 8, left: float = -6.0,
                 right: float = 6.0, bottom: float = -6.0, top: float = 6.0,
                 use_quadratic: bool = False):
        super().__init__()
        self.n_in = n_in_channels
        self.n_bins = 2 * n_bins + 1 if use_quadratic else n_bins
        self.left, self.right, self.bottom, self.top = left, right, bottom, top
        self.use_quadratic = use_quadratic
        self.scn = SimpleConvNet(n_context_channels,
                                 n_in_channels * self.n_bins, n_layers,
                                 kernel_size=1, with_dilation=False,
                                 zero_init=True, use_partial_padding=False)

    def _transform(self, zn, context, inverse):
        B, T, C = zn.shape
        q_tilde = self.scn(context).reshape(B * T, C, self.n_bins)
        z_flat = _at_least_f32(zn.reshape(B * T, C))
        if self.use_quadratic:
            k = self.n_bins // 2
            z_t, log_s = S.unbounded_piecewise_quadratic_transform(
                z_flat, q_tilde[..., :k], q_tilde[..., k:], inverse=inverse)
        elif inverse:
            z_t, log_s = S.piecewise_linear_inverse_transform(z_flat,
                                                              q_tilde)
        else:
            z_t, log_s = S.piecewise_linear_transform(z_flat, q_tilde)
        return z_t.reshape(B, T, C), log_s

    def forward(self, z, context):
        """(spline(z), log s: (B, T, C) quadratic, (B, T, 1) linear)."""
        B, T, C = z.shape
        zn = (z - self.left) / (self.right - self.left)
        out, log_s = self._transform(zn, context, False)
        out = out * (self.top - self.bottom) + self.bottom
        log_s = (log_s.reshape(B, T, -1) if log_s.dim() > 1
                 else log_s.reshape(B, T, 1))
        log_s = log_s + C * (math.log(self.top - self.bottom)
                             - math.log(self.right - self.left))
        return out, log_s

    def inverse(self, z, context):
        zn = (z - self.bottom) / (self.top - self.bottom)
        out, _ = self._transform(zn, context, True)
        return out * (self.right - self.left) + self.left
