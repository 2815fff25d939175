"""Alternative decoders: deterministic regression, end-to-end waveform
and DDPM diffusion.

Counterpart of ``radmmm_tpu/models/alt_decoders.py`` (``StepEmbedding``,
``DiffusionWaveNet``, ``DeterministicDecoder``, ``E2ETTSDecoder``,
``DiffusionSchedule``, ``DiffusionDecoder``). Each is conditioned on the
attention-aligned text context (B, T, C) and, where it says so, the
speaker vector and the F0/energy channels; their losses are in
``losses/flow.py``. Where the JAX modules take a PRNG key, these take
their draws (``t``, ``noise``, the start latent, each step's ``z``) or a
``torch.Generator`` to draw them from; the sampling loop runs its steps
in Python.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radmmm_torch.ops.conv import MaskedConv1d
from radmmm_torch.utils.masking import SeqLens
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig


class StepEmbedding(nn.Module):
    """Sinusoidal diffusion-step embedding -> Linear, SiLU, Linear."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, device=t.device, dtype=torch.float32) / half)
        ang = t.to(torch.float32)[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.Dense_1(F.silu(self.Dense_0(emb)))


class DiffusionWaveNet(nn.Module):
    """Step-conditioned gated WaveNet: each layer gates z_proj + step_proj
    * context_proj through tanh and sigmoid; the residual is 0.5 (h +
    res_skip), the output accumulates 0.5 (out + res_skip). Every conv is
    weight-normed with partial padding and sees the mask."""

    def __init__(self, n_in_channels: int, n_context_dim: int,
                 n_layers: int = 4, n_channels: int = 256,
                 kernel_size: int = 5, n_step_dim: int = 128):
        super().__init__()
        self.n_layers = n_layers
        self.n_channels = n_channels

        def conv(cin, cout, k=1, dilation=1):
            return MaskedConv1d(cin, cout, k, dilation=dilation,
                                use_weight_norm=True,
                                use_partial_padding=True)

        self.start = conv(n_in_channels, n_channels)
        for i in range(n_layers):
            d = 2 ** i
            setattr(self, f"in_{i}",
                    conv(n_channels, 2 * n_channels, kernel_size, d))
            setattr(self, f"cond_{i}",
                    conv(n_context_dim, 2 * n_channels, kernel_size, d))
            setattr(self, f"step_{i}",
                    conv(n_step_dim, 2 * n_channels, kernel_size, d))
            setattr(self, f"res_skip_{i}", conv(n_channels, n_channels))
        self.end = conv(n_channels, n_in_channels)

    def forward(self, z, cond, step_emb, mask=None):
        h = self.start(z, mask)
        output = torch.zeros_like(h)
        step_t = step_emb[:, None, :].expand(-1, z.shape[1], -1)
        c = self.n_channels
        for i in range(self.n_layers):
            acts = (getattr(self, f"in_{i}")(h, mask)
                    + getattr(self, f"step_{i}")(step_t, mask)
                    * getattr(self, f"cond_{i}")(cond, mask))
            gated = torch.tanh(acts[..., :c]) * torch.sigmoid(acts[..., c:])
            res_skip = getattr(self, f"res_skip_{i}")(gated, mask)
            if i < self.n_layers - 1:
                h = 0.5 * (h + res_skip)
            output = 0.5 * (output + res_skip)
        return self.end(output, mask)


class DeterministicDecoder(nn.Module):
    """[context, speaker, F0, energy] (B, T, ·) -> mel (B, T, n_mel)
    through a relu conv stack. The input width is the context's
    (``n_context_dim``), the speaker vector's and one channel each for F0
    and energy (``n_f0_dims``, ``n_energy_avg_dims``: 0 when the call
    passes none)."""

    def __init__(self, n_mel_channels: int = 80, n_speaker_dim: int = 16,
                 n_layers: int = 4, n_channels: int = 512,
                 kernel_size: int = 5, n_context_dim: int = 512,
                 n_f0_dims: int = 1, n_energy_avg_dims: int = 1):
        super().__init__()
        self.n_layers = n_layers
        c = n_context_dim + n_speaker_dim + n_f0_dims + n_energy_avg_dims
        for i in range(n_layers):
            setattr(self, f"conv_{i}", MaskedConv1d(
                c if i == 0 else n_channels, n_channels, kernel_size,
                w_init_gain="relu", use_partial_padding=True,
                use_weight_norm=True))
        self.out = MaskedConv1d(n_channels, n_mel_channels, 1)

    def forward(self, context, spk_vecs, lens: SeqLens, f0=None,
                energy_avg=None):
        B, T = context.shape[:2]
        parts = [context, spk_vecs[:, None, :].expand(B, T, -1)]
        if f0 is not None:
            parts.append(f0[..., None])
        if energy_avg is not None:
            parts.append(energy_avg[..., None])
        h = torch.cat(parts, dim=-1)
        for i in range(self.n_layers):
            h = torch.relu(getattr(self, f"conv_{i}")(h, lens.mask))
        return {"mel_hat": self.out(h, lens.mask)}


class E2ETTSDecoder(nn.Module):
    """End-to-end waveform decoder: the deterministic mel decoder feeding
    a HiFi-GAN generator (v1 at n_mel_channels unless
    ``vocoder_config`` says otherwise), trained with
    ``RADTTSE2EGANLoss``."""

    def __init__(self, n_mel_channels: int = 80, n_speaker_dim: int = 16,
                 n_layers: int = 4, n_channels: int = 512,
                 vocoder_config: Optional[HiFiGANConfig] = None,
                 n_context_dim: int = 512, n_f0_dims: int = 1,
                 n_energy_avg_dims: int = 1):
        super().__init__()
        self.mel_decoder = DeterministicDecoder(
            n_mel_channels, n_speaker_dim, n_layers, n_channels,
            n_context_dim=n_context_dim, n_f0_dims=n_f0_dims,
            n_energy_avg_dims=n_energy_avg_dims)
        self.generator = Generator(
            vocoder_config or HiFiGANConfig(n_mel_channels=n_mel_channels))

    def forward(self, context, spk_vecs, lens: SeqLens, f0=None,
                energy_avg=None):
        out = self.mel_decoder(context, spk_vecs, lens, f0, energy_avg)
        return {"mel_hat": out["mel_hat"],
                "audio_hat": self.generator(out["mel_hat"])}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    n_steps: int = 100
    beta_start: float = 1e-4
    beta_end: float = 0.05

    def betas(self):
        return np.linspace(self.beta_start, self.beta_end, self.n_steps,
                           dtype=np.float32)

    def alpha_bars(self):
        return np.cumprod(1.0 - self.betas())


class DiffusionDecoder(nn.Module):
    """Epsilon-prediction DDPM over mel frames, conditioned on the
    context."""

    def __init__(self, n_mel_channels: int = 80, n_context_dim: int = 512,
                 n_layers: int = 4, n_channels: int = 256,
                 schedule: DiffusionSchedule = DiffusionSchedule()):
        super().__init__()
        self.n_mel_channels = n_mel_channels
        self.schedule = schedule
        self.step_embedding = StepEmbedding(128)
        self.net = DiffusionWaveNet(n_mel_channels, n_context_dim, n_layers,
                                    n_channels)

    def _table(self, values: np.ndarray, like: torch.Tensor):
        return torch.as_tensor(values, device=like.device,
                               dtype=torch.float32)

    def predict_noise(self, noisy_mel, context, t, mask=None):
        return self.net(noisy_mel, context, self.step_embedding(t), mask)

    def forward(self, mel, context, lens: SeqLens,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Training: noise the mel at step ``t`` (B,) with ``noise``, both
        drawn from ``generator`` when not given, and predict the noise ->
        {'noise', 'noise_hat'} for ``RADTTSDiffusionLoss``."""
        B = mel.shape[0]
        if t is None:
            t = torch.randint(0, self.schedule.n_steps, (B,),
                              generator=generator, device=mel.device)
        if noise is None:
            noise = torch.randn(mel.shape, generator=generator,
                                device=mel.device, dtype=mel.dtype)
        abar = self._table(self.schedule.alpha_bars(), mel)[t.long()]
        abar = abar[:, None, None]
        noisy = torch.sqrt(abar) * mel + torch.sqrt(1.0 - abar) * noise
        return {"noise": noise,
                "noise_hat": self.predict_noise(noisy, context, t,
                                                lens.mask)}

    def infer(self, context, lens: SeqLens, x: Optional[torch.Tensor] = None,
              zs: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Ancestral sampling from the start latent ``x`` (B, T, n_mel)
        through the steps n_steps - 1 .. 0, the i-th of them adding
        ``zs[i]``; what is not given is drawn from ``generator``. Returns
        the mel, zero past each length."""
        B, T = context.shape[:2]
        shape = (B, T, self.n_mel_channels)
        n = self.schedule.n_steps
        if x is None:
            x = torch.randn(shape, generator=generator,
                            device=context.device, dtype=context.dtype)
        betas = self._table(self.schedule.betas(), context)
        alphas = 1.0 - betas
        abars = self._table(self.schedule.alpha_bars(), context)
        for i, t in enumerate(range(n - 1, -1, -1)):
            tb = torch.full((B,), t, dtype=torch.int32,
                            device=context.device)
            eps = self.predict_noise(x, context, tb, lens.mask)
            a, ab, b = alphas[t], abars[t], betas[t]
            mean = (x - b / torch.sqrt(1.0 - ab) * eps) / torch.sqrt(a)
            z = (zs[i] if zs is not None else torch.randn(
                shape, generator=generator, device=context.device,
                dtype=context.dtype))
            x = mean + (torch.sqrt(b) if t > 0 else 0.0) * z
        return x * lens.fmask(x.dtype)[..., None]
