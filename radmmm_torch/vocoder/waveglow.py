"""WaveGlow: the flow-based neural vocoder (mel -> waveform), trainable.

Counterpart of ``radmmm_tpu/vocoder/waveglow.py`` (the published WaveGlow
design of the reference's vendored waveglow_for_LIMMITS23 tree): audio
squeezed into groups of ``n_group`` samples, a stack of flows of
[invertible 1x1 conv + affine coupling], each coupling a gated
(tanh x sigmoid) dilated conv stack conditioned on the mel upsampled by a
transposed conv, early exits of ``n_early_size`` channels every
``n_early_every`` flows. Training is maximum likelihood
(``waveglow_loss``); inference draws z ~ N(0, sigma^2), or takes it as
``residual``, through the reversed flows.

``load_torch_waveglow_params`` reads the vendored tree's checkpoints and
``upstream_waveglow_state_dict`` writes them.

Layout: channels last at the boundary, as in the JAX module: audio
(B, T), mel (B, T_mel, n_mel), z (B, T // n_group, n_group) with the early
exits first. Inside ``GatedWN`` the activations are (B, C, T) for
``F.conv1d``. Parameter names mirror the JAX leaves in PyTorch's layouts:
``upsample_kernel_w`` (C_in, C_out, K) of the ConvTranspose,
``convinv_i.weight``, ``wn_i.{start, in_j, cond_j, res_skip_j}.{v, g,
bias}`` and ``wn_i.end.{weight, bias}``.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radmmm_torch.ops.conv import MaskedConv1d, conv1d
from radmmm_torch.ops.invertible import InvertibleConv


def _conv(m: MaskedConv1d, x: torch.Tensor) -> torch.Tensor:
    """``m``'s convolution of a (B, C, T) tensor, no mask, at the conv
    precision."""
    return conv1d(x, m.kernel(), m.padding, m.dilation, m.bias)


class GatedWN(nn.Module):
    """WaveNet stack with gated units, the mel conditioning added before
    the gate; ``end`` starts at zero."""

    def __init__(self, n_half: int, n_cond: int, n_channels: int = 256,
                 n_layers: int = 8, kernel_size: int = 3):
        super().__init__()
        self.n_channels, self.n_layers = n_channels, n_layers
        self.start = MaskedConv1d(n_half, n_channels, 1, use_weight_norm=True)
        for i in range(n_layers):
            self.add_module(f"in_{i}", MaskedConv1d(
                n_channels, 2 * n_channels, kernel_size, dilation=2 ** i,
                use_weight_norm=True))
            self.add_module(f"cond_{i}", MaskedConv1d(
                n_cond, 2 * n_channels, 1, use_weight_norm=True))
            self.add_module(f"res_skip_{i}", MaskedConv1d(
                n_channels, 2 * n_channels if i < n_layers - 1
                else n_channels, 1, use_weight_norm=True))
        self.end = MaskedConv1d(n_channels, 2 * n_half, 1, zero_init=True)

    def forward(self, z_half: torch.Tensor, cond: torch.Tensor
                ) -> torch.Tensor:
        """z_half (B, T, n_half), cond (B, T, n_cond) -> (B, T, 2 n_half)."""
        nc = self.n_channels
        h = _conv(self.start, z_half.transpose(1, 2))
        cond = cond.transpose(1, 2)
        output = 0.0
        for i in range(self.n_layers):
            acts = (_conv(getattr(self, f"in_{i}"), h)
                    + _conv(getattr(self, f"cond_{i}"), cond))
            gated = torch.tanh(acts[:, :nc]) * torch.sigmoid(acts[:, nc:])
            res_skip = _conv(getattr(self, f"res_skip_{i}"), gated)
            if i < self.n_layers - 1:
                h = h + res_skip[:, :nc]
                output = output + res_skip[:, nc:]
            else:
                output = output + res_skip
        return _conv(self.end, output).transpose(1, 2)


class WaveGlow(nn.Module):
    def __init__(self, n_mel_channels: int = 80, n_flows: int = 12,
                 n_group: int = 8, n_early_every: int = 4,
                 n_early_size: int = 2, wn_channels: int = 256,
                 wn_layers: int = 8, hop_length: int = 256,
                 upsample_kernel: int = 1024):
        super().__init__()
        self.n_mel_channels, self.n_flows = n_mel_channels, n_flows
        self.n_group, self.hop_length = n_group, hop_length
        self.n_early_every, self.n_early_size = n_early_every, n_early_size
        self.upsample_kernel_w = nn.Parameter(torch.randn(
            n_mel_channels, n_mel_channels, upsample_kernel) * 0.02)
        self.upsample_bias = nn.Parameter(torch.zeros(n_mel_channels))
        for i, c in enumerate(self._channel_sizes()):
            self.add_module(f"convinv_{i}", InvertibleConv(c, init_seed=i))
            self.add_module(f"wn_{i}", GatedWN(
                c // 2, n_mel_channels * n_group, wn_channels, wn_layers))

    @property
    def exit_steps(self):
        return [i for i in range(1, self.n_flows)
                if i % self.n_early_every == 0]

    def _channel_sizes(self):
        sizes, c = [], self.n_group
        for i in range(self.n_flows):
            if i > 0 and i % self.n_early_every == 0:
                c -= self.n_early_size
            sizes.append(c)
        return sizes

    def upsample_mel(self, mel: torch.Tensor, n_samples: int
                     ) -> torch.Tensor:
        """(B, T_mel, n_mel) -> grouped cond (B, n_samples // n_group,
        n_mel * n_group), channel-major within a group."""
        up = F.conv_transpose1d(mel.transpose(1, 2), self.upsample_kernel_w,
                                self.upsample_bias,
                                stride=self.hop_length)[..., :n_samples]
        B, C, T = up.shape
        g = self.n_group
        up = up[..., :(T // g) * g].reshape(B, C, T // g, g)
        return up.permute(0, 2, 1, 3).reshape(B, T // g, C * g)

    def _flow(self, i: int, z: torch.Tensor, cond: torch.Tensor):
        """(z0, b, log_s) of flow i's coupling: b first, then log_s."""
        n_half = z.shape[-1] // 2
        params = getattr(self, f"wn_{i}")(z[..., :n_half], cond)
        return z[..., :n_half], params[..., :n_half], params[..., n_half:]

    def forward(self, audio: torch.Tensor, mel: torch.Tensor
                ) -> Dict[str, object]:
        """Training direction, audio (B, T), mel (B, T_mel, n_mel) ->
        {z, log_s_list, log_det_W_list}."""
        B, T = audio.shape
        g = self.n_group
        z = audio[:, :(T // g) * g].reshape(B, T // g, g)
        cond = self.upsample_mel(mel, T)[:, :z.shape[1]]
        z_out, log_s_list, log_det_W_list = [], [], []
        exits = set(self.exit_steps)
        for i in range(self.n_flows):
            if i in exits:
                z_out.append(z[..., :self.n_early_size])
                z = z[..., self.n_early_size:]
            z, log_det_w = getattr(self, f"convinv_{i}")(z)
            z0, b, log_s = self._flow(i, z, cond)
            z1 = torch.exp(log_s) * z[..., z0.shape[-1]:] + b
            z = torch.cat([z0, z1], dim=-1)
            log_s_list.append(log_s)
            log_det_W_list.append(log_det_w)
        z_out.append(z)
        return {"z": torch.cat(z_out, dim=-1), "log_s_list": log_s_list,
                "log_det_W_list": log_det_W_list}

    def draw_residual(self, mel: torch.Tensor, sigma: float,
                      generator: Optional[torch.Generator],
                      n_samples: Optional[int] = None) -> torch.Tensor:
        """The N(0, sigma^2) noise ``infer`` draws for ``mel``,
        (B, Tg, n_group), from ``generator``: Tg is the length of
        ``upsample_mel``'s grouped output, known from the shapes alone."""
        B, T_mel = mel.shape[:2]
        if n_samples is None:
            n_samples = T_mel * self.hop_length
        up = (T_mel - 1) * self.hop_length + self.upsample_kernel_w.shape[-1]
        Tg = min(up, n_samples) // self.n_group
        return torch.randn((B, Tg, self.n_group), generator=generator,
                           device=mel.device, dtype=mel.dtype) * sigma

    def cache_inverses(self) -> "WaveGlow":
        """Keep each 1x1's inverse for ``infer`` (fixed weights)."""
        for i in range(self.n_flows):
            getattr(self, f"convinv_{i}").cache_inverse()
        return self

    def infer(self, mel: torch.Tensor, sigma: float = 1.0,
              n_samples: Optional[int] = None,
              residual: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel (B, T_mel, n_mel) -> audio (B, T_mel * hop). ``residual``
        (B, Tg, n_group), in ``forward``'s z layout, replaces the draw of
        N(0, sigma^2) from ``generator``, so ``infer(residual=forward(
        audio, mel)["z"])`` rebuilds the audio."""
        if n_samples is None:
            n_samples = mel.shape[1] * self.hop_length
        cond = self.upsample_mel(mel, n_samples)
        B, Tg, _ = cond.shape
        if residual is None:
            residual = self.draw_residual(mel, sigma, generator, n_samples)
        else:
            residual = residual[:, :Tg]
        n_early_total = len(self.exit_steps) * self.n_early_size
        z = residual[..., n_early_total:]
        exit_stack = list(self.exit_steps)
        for i in range(self.n_flows - 1, -1, -1):
            z0, b, log_s = self._flow(i, z, cond)
            z1 = (z[..., z0.shape[-1]:] - b) * torch.exp(-log_s)
            z = getattr(self, f"convinv_{i}").inverse(
                torch.cat([z0, z1], dim=-1))
            if exit_stack and i == exit_stack[-1]:
                exit_stack.pop()
                lo = len(exit_stack) * self.n_early_size
                z = torch.cat([residual[..., lo:lo + self.n_early_size], z],
                              dim=-1)
        return z.reshape(B, Tg * z.shape[-1])


def load_waveglow_config(config_path: Optional[str]) -> dict:
    """``WaveGlow`` kwargs from the vendored tree's train config.json
    (``waveglow_config`` with its ``WN_config``, and ``data_config``'s
    hop) or a flat json."""
    kwargs = {}
    if config_path:
        with open(config_path) as f:
            raw = json.load(f)
        wg = raw.get("waveglow_config", raw)
        wn = wg.pop("WN_config", {})
        kwargs = dict(wg)
        if "n_layers" in wn:
            kwargs["wn_layers"] = wn["n_layers"]
        if "n_channels" in wn:
            kwargs["wn_channels"] = wn["n_channels"]
        data = raw.get("data_config", {})
        if "hop_length" in data:
            kwargs["hop_length"] = data["hop_length"]
    return kwargs


def load_torch_waveglow_params(state_dict, model: WaveGlow
                               ) -> Dict[str, torch.Tensor]:
    """A torch WaveGlow checkpoint of the vendored tree's glow.py naming
    (upsample, convinv.N.conv, WN.N.{start, in_layers.M, cond_layer,
    res_skip_layers.M, end}) -> this module's state dict. Takes weight-
    normed (weight_v / weight_g) and plain (remove_weightnorm'd) weights;
    the reference's one fused cond_layer (2 n_channels n_layers rows) is
    sliced into per-layer rows, exact since weight norm is per row."""
    def npy(t):
        return np.asarray(t.detach().cpu().numpy()
                          if hasattr(t, "detach") else t)

    sd: Dict[str, torch.Tensor] = {}

    def put(key, a):
        sd[key] = torch.from_numpy(np.array(a))

    def wnorm_conv(ours, base, rows=None):
        if f"{base}.weight_v" in state_dict:
            v = npy(state_dict[f"{base}.weight_v"])
            g = npy(state_dict[f"{base}.weight_g"]).reshape(-1)
        else:
            v = npy(state_dict[f"{base}.weight"])
            g = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)
        b = npy(state_dict[f"{base}.bias"])
        if rows is not None:
            lo, hi = rows
            v, g, b = v[lo:hi], g[lo:hi], b[lo:hi]
        put(f"{ours}.v", v)
        put(f"{ours}.g", g)
        put(f"{ours}.bias", b)

    nc, n_layers = model.wn_0.n_channels, model.wn_0.n_layers
    put("upsample_kernel_w", npy(state_dict["upsample.weight"]))
    put("upsample_bias", npy(state_dict["upsample.bias"]))
    for i in range(model.n_flows):
        put(f"convinv_{i}.weight",
            npy(state_dict[f"convinv.{i}.conv.weight"])[..., 0])
        wnorm_conv(f"wn_{i}.start", f"WN.{i}.start")
        put(f"wn_{i}.end.weight", npy(state_dict[f"WN.{i}.end.weight"]))
        put(f"wn_{i}.end.bias", npy(state_dict[f"WN.{i}.end.bias"]))
        for j in range(n_layers):
            wnorm_conv(f"wn_{i}.in_{j}", f"WN.{i}.in_layers.{j}")
            wnorm_conv(f"wn_{i}.cond_{j}", f"WN.{i}.cond_layer",
                       rows=(2 * nc * j, 2 * nc * (j + 1)))
            wnorm_conv(f"wn_{i}.res_skip_{j}",
                       f"WN.{i}.res_skip_layers.{j}")
    return sd


def upstream_waveglow_state_dict(model: WaveGlow, weight_norm: bool = True
                                 ) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_torch_waveglow_params``: ``model``'s weights
    on the host under the vendored tree's names, the per-layer cond convs
    fused into one ``cond_layer``; with ``weight_norm`` False the convs
    hold their normed kernels as plain weights (remove_weightnorm)."""
    def host(t):
        return t.detach().cpu()

    sd = {"upsample.weight": host(model.upsample_kernel_w),
          "upsample.bias": host(model.upsample_bias)}

    def conv(m: MaskedConv1d):
        if not weight_norm:
            return {"weight": host(m.kernel()), "bias": host(m.bias)}
        return {"weight_v": host(m.v), "weight_g": host(m.g)[:, None, None],
                "bias": host(m.bias)}

    for i in range(model.n_flows):
        wn = getattr(model, f"wn_{i}")
        sd[f"convinv.{i}.conv.weight"] = host(
            getattr(model, f"convinv_{i}").weight)[..., None]
        layers = {"start": conv(wn.start)}
        for j in range(wn.n_layers):
            layers[f"in_layers.{j}"] = conv(getattr(wn, f"in_{j}"))
            layers[f"res_skip_layers.{j}"] = conv(
                getattr(wn, f"res_skip_{j}"))
        cond = [conv(getattr(wn, f"cond_{j}")) for j in range(wn.n_layers)]
        layers["cond_layer"] = {k: torch.cat([c[k] for c in cond])
                                for k in cond[0]}
        layers["end"] = {"weight": host(wn.end.weight),
                         "bias": host(wn.end.bias)}
        for name, leaves in layers.items():
            for k, t in leaves.items():
                sd[f"WN.{i}.{name}.{k}"] = t
    return sd


def waveglow_loss(outputs, sigma: float = 1.0) -> torch.Tensor:
    """Flow NLL over all audio samples (fixed segments, no mask); each 1x1
    log-det applies once per grouped frame."""
    z = outputs["z"]
    log_s_total = sum(torch.sum(ls) for ls in outputs["log_s_list"])
    frames = z.shape[0] * z.shape[1]
    log_det_total = sum(outputs["log_det_W_list"]) * frames
    prior = torch.sum(z * z) / (2 * sigma * sigma)
    return (prior - log_s_total - log_det_total) / z.numel()
