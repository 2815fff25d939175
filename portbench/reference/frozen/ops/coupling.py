"""The flow's affine coupling and its WaveNet parameter predictor (a
frozen copy of the port's ``ops/coupling.py``, cut to what the
benchmark's configurations build: ``WN``, ``scaling_and_logs`` at "tanh",
``AffineCoupling`` with a WaveNet). The forward (training) direction
returns the coupled z and log s, the inverse (sampling) direction undoes
it. Where the JAX module convolves without a mask (the WN ``start``,
``res_skip`` and ``end``), so does this one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.ops.conv import MaskedConv1d


class WN(nn.Module):
    """(z_half (B,T,C_half), context (B,T,C_ctx)) -> (B, T, 2*C_half)."""

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

    def forward(self, z, context, mask=None):
        h = self.start(torch.cat([z, context], dim=-1))
        output = torch.zeros_like(h)
        for i in range(self.n_layers):
            h = self.act(getattr(self, f"in_{i}")(h, mask))
            output = output + self.act(getattr(self, f"res_skip_{i}")(h))
        return self.end(output)


def scaling_and_logs(u: torch.Tensor, scaling_fn: str):
    """Constrained scale and its log; 'tanh' (the shipped config) is
    s = tanh(u) + 1 + 1e-6."""
    if scaling_fn != "tanh":
        raise ValueError(f"unsupported scaling fn {scaling_fn}")
    s = torch.tanh(u) + 1.0 + 1e-6
    return s, torch.log(s)


class AffineCoupling(nn.Module):
    """Split-half affine coupling z1 <- s(z0, ctx) * z1 + b(z0, ctx), the
    parameters from a WaveNet over z0 and the context."""

    def __init__(self, n_mel_channels: int, n_context_channels: int,
                 n_layers: int, affine_model: str = "wavenet",
                 scaling_fn: str = "tanh",
                 affine_activation: str = "softplus",
                 with_dilation: bool = True, kernel_size: int = 5,
                 n_channels: int = 1024, use_partial_padding: bool = False):
        super().__init__()
        if affine_model != "wavenet":
            raise ValueError(f"unsupported affine model {affine_model}")
        self.n_half = n_mel_channels // 2
        self.scaling_fn = scaling_fn
        # the JAX module leaves WN's dilation at its default whatever
        # with_dilation says; so does this one
        self.wn = WN(self.n_half, n_context_channels, n_layers,
                     n_channels, kernel_size, affine_activation,
                     use_partial_padding)

    def _params(self, z0, context, mask):
        params = self.wn(z0, context, mask)
        s, log_s = scaling_and_logs(params[..., :self.n_half],
                                    self.scaling_fn)
        return s, log_s, params[..., self.n_half:]

    def forward(self, z, context, mask=None, train: bool = True):
        """(concat(z0, s * z1 + b), log s)."""
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        s, log_s, b = self._params(z0, context, mask)
        return torch.cat([z0, s * z1 + b], dim=-1), log_s

    def inverse(self, z, context, mask=None, train: bool = True):
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        s, _, b = self._params(z0, context, mask)
        return torch.cat([z0, (z1 - b) / s], dim=-1)
