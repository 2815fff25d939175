"""HiFi-GAN's generator: a frozen copy of the port's
``vocoder/hifigan.Generator`` with its conv_post + tanh head and
``ResBlock1``, the v1 generator the benchmark serves (the iSTFTNet head,
``ResBlock2``, the discriminators, the losses and the denoiser are not
copied).

Counterpart of ``radmmm_tpu/vocoder/hifigan.py``: mel (B, T, n_mel) ->
waveform (B, T * hop) in [-1, 1]. Weights are weight-normed where the JAX
module's are: convs keep ``g`` per output channel, the upsampling
ConvTranspose keeps ``g`` per *input* channel (torch's weight_norm(dim=0)
on a (C_in, C_out, K) weight). Parameter names mirror the JAX module's
leaves (``conv_pre_v``, ``up_0_g``, ``resblock_0_1.c1_2_v`` ...), stored in
PyTorch's layouts: conv (C_out, C_in, K), ConvTranspose (C_in, C_out, K).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.ops.conv import weight_norm_kernel

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """The upstream generator config (v1 at 22,050 Hz by default)."""
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    gen_istft_n_fft: Optional[int] = None
    gen_istft_hop: int = 4

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))

    @classmethod
    def from_dict(cls, fields: Dict[str, Any]) -> "HiFiGANConfig":
        """The config of a yaml or json dict of its fields (lists, nested
        too, as tuples)."""
        def tuples(v):
            return tuple(tuples(x) for x in v) if isinstance(v, list) else v
        return cls(**{k: tuples(v) for k, v in fields.items()})


def _add_wn_conv(module: nn.Module, name: str, cin: int, cout: int, k: int,
                 transpose: bool = False):
    """Registers {name}_v, {name}_g, {name}_bias: v ~ N(0, 0.01), g = ||v||
    (per output channel, or per input channel for a ConvTranspose)."""
    if transpose:
        v = torch.randn(cin, cout, k) * 0.01
    else:
        v = torch.randn(cout, cin, k) * 0.01
    module.register_parameter(f"{name}_v", nn.Parameter(v))
    module.register_parameter(f"{name}_g", nn.Parameter(
        torch.linalg.vector_norm(v, dim=(1, 2)).clone()))
    module.register_parameter(f"{name}_bias",
                              nn.Parameter(torch.zeros(cout)))


def _wn(module: nn.Module, name: str) -> torch.Tensor:
    return weight_norm_kernel(getattr(module, f"{name}_v"),
                              getattr(module, f"{name}_g"))


def _conv(module: nn.Module, name: str, x: torch.Tensor,
          dilation: int = 1) -> torch.Tensor:
    """Same-padded conv of a (B, C, T) tensor with a weight-normed kernel."""
    w = _wn(module, name)
    return F.conv1d(x, w, getattr(module, f"{name}_bias"),
                    padding=dilation * (w.shape[-1] - 1) // 2,
                    dilation=dilation)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        for i in range(len(self.dilation)):
            _add_wn_conv(self, f"c1_{i}", channels, channels, kernel_size)
            _add_wn_conv(self, f"c2_{i}", channels, channels, kernel_size)

    def forward(self, x):
        for i, d in enumerate(self.dilation):
            xt = _conv(self, f"c1_{i}", F.leaky_relu(x, LRELU_SLOPE), d)
            x = x + _conv(self, f"c2_{i}", F.leaky_relu(xt, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel (B, T, n_mel) -> waveform (B, T * hop_length) in [-1, 1]."""

    def __init__(self, config: HiFiGANConfig):
        super().__init__()
        h = self.config = config
        if h.resblock != "1" or h.gen_istft_n_fft is not None:
            raise ValueError("only the v1 generator's ResBlock1 and "
                             "conv_post head are copied")
        _add_wn_conv(self, "conv_pre", h.n_mel_channels,
                     h.upsample_initial_channel, 7)
        res = ResBlock1
        ch = h.upsample_initial_channel
        for i, ks in enumerate(h.upsample_kernel_sizes):
            out_ch = h.upsample_initial_channel // (2 ** (i + 1))
            _add_wn_conv(self, f"up_{i}", ch, out_ch, ks, transpose=True)
            ch = out_ch
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", res(ch, rk, rd))
        _add_wn_conv(self, "conv_post", ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.config
        x = _conv(self, "conv_pre", mel.transpose(1, 2))
        n_res = len(h.resblock_kernel_sizes)
        for i, (u, ks) in enumerate(zip(h.upsample_rates,
                                        h.upsample_kernel_sizes)):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = F.conv_transpose1d(x, _wn(self, f"up_{i}"),
                                   getattr(self, f"up_{i}_bias"), stride=u,
                                   padding=(ks - u) // 2)
            xs = getattr(self, f"resblock_{i}_0")(x)
            for j in range(1, n_res):
                xs = xs + getattr(self, f"resblock_{i}_{j}")(x)
            x = xs / n_res
        x = F.leaky_relu(x, 0.01)   # the final lrelu uses the default slope
        return torch.tanh(_conv(self, "conv_post", x))[:, 0]
