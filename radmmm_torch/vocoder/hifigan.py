"""HiFi-GAN: generator, discriminators, GAN losses, denoiser.

Counterpart of ``radmmm_tpu/vocoder/hifigan.py`` (the reference's
vocoders/hifigan_models.py and hifigan_denoiser.py):

* ``Generator``: mel (B, T, n_mel) -> waveform (B, T * hop) in [-1, 1],
  with the conv_post + tanh head or the iSTFTNet head (magnitude and phase
  frames through an inverse STFT, arXiv:2203.02395);
* ``MultiPeriodDiscriminator`` (periods 2, 3, 5, 7, 11) and
  ``MultiScaleDiscriminator`` (3 scales), the least-squares GAN losses
  and the feature-matching loss;
* ``gaussian_blur_kernels`` / ``gaussian_blur_augment``, the generator's
  input augmentation in vocoder training;
* ``Denoiser``, which subtracts the vocoder's bias spectrum;
* ``load_torch_generator_params``: an upstream ``g_*`` state dict ->
  this ``Generator``'s state dict, and ``upstream_generator_state_dict``
  its inverse (a ``vocoder-fit`` generator saved as a ``g_*`` file).

Weights are weight-normed where the JAX module's are: convs keep ``g`` per
output channel, the upsampling ConvTranspose keeps ``g`` per *input*
channel (torch's weight_norm(dim=0) on a (C_in, C_out, K) weight), the
period discriminator's ``g`` starts at ones. Parameter names mirror the JAX
module's leaves (``conv_pre_v``, ``up_0_g``, ``resblock_0_1.c1_2_v``,
``period_2.conv_0_v``, ``scale_0.conv_3_kernel`` ...), stored in PyTorch's
layouts: conv (C_out, C_in, K), ConvTranspose (C_in, C_out, K), the
period discriminator's 2-D convs (C_out, C_in, K, 1). The multi-
discriminators run real and generated audio as one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radmmm_torch.ops.conv import weight_norm_kernel
from radmmm_torch.ops.stft import MelSpectrogram, istft_frames
from radmmm_torch.utils.device import resolve_device

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
        hop = int(np.prod(self.upsample_rates))
        if self.gen_istft_n_fft is not None:
            hop *= self.gen_istft_hop
        return hop

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


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.dilation = tuple(dilation)
        for i in range(len(self.dilation)):
            _add_wn_conv(self, f"c_{i}", channels, channels, kernel_size)

    def forward(self, x):
        for i, d in enumerate(self.dilation):
            x = x + _conv(self, f"c_{i}", F.leaky_relu(x, LRELU_SLOPE), d)
        return x


class Generator(nn.Module):
    """mel (B, T, n_mel) -> waveform (B, T * hop_length) in [-1, 1]."""

    def __init__(self, config: HiFiGANConfig):
        super().__init__()
        h = self.config = config
        _add_wn_conv(self, "conv_pre", h.n_mel_channels,
                     h.upsample_initial_channel, 7)
        res = ResBlock1 if h.resblock == "1" else ResBlock2
        ch = h.upsample_initial_channel
        for i, ks in enumerate(h.upsample_kernel_sizes):
            out_ch = h.upsample_initial_channel // (2 ** (i + 1))
            _add_wn_conv(self, f"up_{i}", ch, out_ch, ks, transpose=True)
            ch = out_ch
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", res(ch, rk, rd))
        if h.gen_istft_n_fft is None:
            _add_wn_conv(self, "conv_post", ch, 1, 7)
        else:
            # the iSTFTNet head: magnitude and phase of n_fft // 2 + 1 bins
            _add_wn_conv(self, "conv_post", ch,
                         2 * (h.gen_istft_n_fft // 2 + 1), 7)
            # numpy's (and jnp's) hanning is the symmetric Hann window
            self.register_buffer("istft_window", torch.from_numpy(
                np.hanning(h.gen_istft_n_fft).astype(np.float32)),
                persistent=False)

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
        if h.gen_istft_n_fft is None:
            return torch.tanh(_conv(self, "conv_post", x))[:, 0]
        # iSTFTNet head, synthesised in f32: (B, 2K, T') -> (B, T', 2K)
        x = _conv(self, "conv_post", x).float().transpose(1, 2)
        k = h.gen_istft_n_fft // 2 + 1
        mag = torch.exp(torch.clamp(x[..., :k], -8.0, 8.0))
        audio = istft_frames(mag, x[..., k:], h.gen_istft_n_fft,
                             h.gen_istft_hop, self.istft_window)
        # the centre trim loses n_fft - hop samples: pad them back split
        # evenly, to exactly T_mel * hop_length samples
        want = mel.shape[1] * h.hop_length
        missing = want - audio.shape[1]
        lo = max(0, missing // 2)
        hi = max(0, missing - lo)
        return F.pad(audio, (lo, hi))[:, :want]


# ---------------------------------------------------------------------------
# input augmentation of vocoder training
# ---------------------------------------------------------------------------
def gaussian_blur_kernels(kernel_size: Tuple[int, int] = (5, 5),
                          sigmas: Sequence[float] = (0.5, 1.0, 1.5, 2.0)
                          ) -> torch.Tensor:
    """Bank of normalised 2-D Gaussian kernels (n_sigmas, k_mel, k_time):
    the separable product of 1-D Gaussians of the reference's
    GaussianBlurAugmentation.initialize_kernels, built in numpy (float64
    once the float64 constant enters) and rounded to float32, as the JAX
    package builds it."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32)
                          for s in kernel_size], indexing="ij")
    ks = []
    for sigma in sigmas:
        k = np.ones(kernel_size, np.float32)
        for size, g in zip(kernel_size, grids):
            mean = (size - 1) / 2
            k = k * np.exp(-((g - mean) / sigma) ** 2 / 2) \
                / (sigma * np.sqrt(2 * np.pi))
        ks.append(k / k.sum())
    return torch.from_numpy(np.stack(ks).astype(np.float32))


def blur_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of a training step's blur draws, seeded from
    (seed, step) where the JAX package folds the step into its key: a
    resumed run draws as an uninterrupted one."""
    return torch.Generator().manual_seed(int(
        np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]))


def gaussian_blur_augment(mel: torch.Tensor, generator: torch.Generator,
                          kernels: torch.Tensor, p_blurring: float
                          ) -> torch.Tensor:
    """With probability ``p_blurring`` blur the (B, T, n_mel) mel with a
    kernel of ``kernels`` drawn uniformly (reflect padding, one 2-D conv);
    else return it unchanged (GaussianBlurAugmentation.forward,
    hifigan_models.py:92-101). Both draws come from ``generator`` on the
    host. The reference's kernels are (mel, time) on a (B, 1, n_mel, T)
    image; here the image is (B, 1, T, n_mel), so the kernel is
    transposed."""
    i, blurred = blur_draws(generator, kernels.shape[0], p_blurring)
    return blur_mel(mel, kernels[i]) if blurred else mel


def blur_draws(generator: torch.Generator, n_kernels: int,
               p_blurring: float) -> Tuple[int, bool]:
    """``gaussian_blur_augment``'s two host draws from ``generator``: the
    kernel's index, then whether to blur."""
    i = int(torch.randint(0, n_kernels, (), generator=generator))
    return i, float(torch.rand((), generator=generator)) <= p_blurring


def blur_mel(mel: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The (B, T, n_mel) mel blurred by one (k_mel, k_time) kernel of the
    bank, reflect-padded."""
    k2d = kernel.t().to(mel.device, mel.dtype)          # (k_time, k_mel)
    pad_t, pad_m = (k2d.shape[0] - 1) // 2, (k2d.shape[1] - 1) // 2
    x = F.pad(mel[:, None], (pad_m, pad_m, pad_t, pad_t), mode="reflect")
    return F.conv2d(x, k2d[None, None])[:, 0]


# ---------------------------------------------------------------------------
# discriminators of vocoder training (periods per hifigan_models.py:409)
# ---------------------------------------------------------------------------
class DiscriminatorP(nn.Module):
    """Period discriminator: (B, T) -> (score (B, N), feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period, self.stride = period, stride
        cin = 1
        for i, ch in enumerate((32, 128, 512, 1024)):
            self.register_parameter(f"conv_{i}_v", nn.Parameter(
                torch.randn(ch, cin, kernel_size, 1) * 0.01))
            # g starts at ones, not at ||v||
            self.register_parameter(f"conv_{i}_g",
                                    nn.Parameter(torch.ones(ch)))
            self.register_parameter(f"conv_{i}_bias",
                                    nn.Parameter(torch.zeros(ch)))
            cin = ch
        # no weight norm on the output conv, despite its name
        self.conv_out_v = nn.Parameter(torch.randn(1, cin, 3, 1) * 0.01)
        self.conv_out_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor):
        B, T = x.shape
        pad = (self.period - T % self.period) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.reshape(B, 1, -1, self.period)
        fmap = []
        for i in range(4):
            w = weight_norm_kernel(getattr(self, f"conv_{i}_v"),
                                   getattr(self, f"conv_{i}_g"))
            x = F.conv2d(x, w, getattr(self, f"conv_{i}_bias"),
                         stride=(self.stride, 1), padding=(2, 0))
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = F.conv2d(x, self.conv_out_v, self.conv_out_bias, padding=(1, 0))
        fmap.append(x)
        return x.reshape(B, -1), fmap


# (out channels, kernel, stride, groups) of the scale discriminator
_SCALE_LAYERS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
                 (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
                 (1024, 5, 1, 1))


class DiscriminatorS(nn.Module):
    """Scale discriminator over (possibly pooled) raw audio: grouped
    convs without weight or spectral norm, as in the JAX package."""

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (ch, k, _, groups) in enumerate(_SCALE_LAYERS):
            self.register_parameter(f"conv_{i}_kernel", nn.Parameter(
                torch.randn(ch, cin // groups, k) * 0.01))
            self.register_parameter(f"conv_{i}_bias",
                                    nn.Parameter(torch.zeros(ch)))
            cin = ch
        self.conv_out_kernel = nn.Parameter(torch.randn(1, cin, 3) * 0.01)
        self.conv_out_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor):
        x = x[:, None]
        fmap = []
        for i, (_, k, stride, groups) in enumerate(_SCALE_LAYERS):
            x = F.conv1d(x, getattr(self, f"conv_{i}_kernel"),
                         getattr(self, f"conv_{i}_bias"), stride=stride,
                         padding=(k - 1) // 2, groups=groups)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = F.conv1d(x, self.conv_out_kernel, self.conv_out_bias, padding=1)
        fmap.append(x)
        return x[:, 0], fmap


def _real_and_generated(d: nn.Module, y: torch.Tensor, y_hat: torch.Tensor):
    """One discriminator over real and generated audio as one batch ->
    (score_r, score_g, fmap_r, fmap_g)."""
    B = y.shape[0]
    score, fmap = d(torch.cat([y, y_hat]))
    return (score[:B], score[B:], [f[:B] for f in fmap],
            [f[B:] for f in fmap])


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", DiscriminatorP(p))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (scores_r, scores_g, fmaps_r, fmaps_g), one per period."""
        outs = [_real_and_generated(getattr(self, f"period_{p}"), y, y_hat)
                for p in self.periods]
        return tuple(list(t) for t in zip(*outs))


def _pool_same(x: torch.Tensor) -> torch.Tensor:
    """XLA's SAME average pool of the JAX package (window 4, stride 2; the
    zero padding, 1 and 1 for even T, 1 and 2 for odd T, counts in the
    mean), not the reference's AvgPool1d(4, 2, padding=2)."""
    pad = max((-(-x.shape[-1] // 2) - 1) * 2 + 4 - x.shape[-1], 0)
    x = F.pad(x[:, None], (pad // 2, pad - pad // 2))
    return F.avg_pool1d(x, 4, 2)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"scale_{i}", DiscriminatorS())

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (scores_r, scores_g, fmaps_r, fmaps_g), one per scale."""
        outs = []
        for i in range(self.n_scales):
            outs.append(_real_and_generated(getattr(self, f"scale_{i}"),
                                            y, y_hat))
            if i < self.n_scales - 1:
                y, y_hat = _pool_same(y), _pool_same(y_hat)
        return tuple(list(t) for t in zip(*outs))


# ---- GAN losses (hifigan_models.py:349-406, least-squares form) ----------
def feature_loss(fmaps_r, fmaps_g) -> torch.Tensor:
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(outs_r, outs_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(outs_r, outs_g):
        loss = loss + torch.mean((1 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_adv_loss(outs_g) -> torch.Tensor:
    return sum(torch.mean((1 - dg) ** 2) for dg in outs_g)


# ---- denoiser -------------------------------------------------------------
class Denoiser:
    """Subtracts the vocoder's bias spectrum (hifigan_denoiser.py:25-59):
    the magnitude of the first STFT frame of what ``generator_fn`` makes of
    an all-zero mel, times ``strength``, floored at zero."""

    def __init__(self, generator_fn: Callable[[torch.Tensor], torch.Tensor],
                 n_mel_channels: int = 80, filter_length: int = 1024,
                 n_overlap: int = 4, win_length: int = 1024,
                 device: str | torch.device = "cuda"):
        device = resolve_device(device)
        self.stft = MelSpectrogram(filter_length=filter_length,
                                   hop_length=filter_length // n_overlap,
                                   win_length=win_length)
        with torch.no_grad():
            bias_audio = generator_fn(
                torch.zeros((1, 88, n_mel_channels), device=device))
            self.bias_spec = self.stft.stft(bias_audio).abs()[:, :1, :]

    def __call__(self, audio: torch.Tensor, strength: float = 0.1
                 ) -> torch.Tensor:
        spec = self.stft.stft(audio)
        mag = torch.clamp_min(spec.abs() - self.bias_spec * strength, 0.0)
        return self.stft.istft(mag, torch.angle(spec))


# ---- upstream checkpoint conversion --------------------------------------
def load_torch_generator_params(state_dict: Dict[str, Any],
                                config: HiFiGANConfig
                                ) -> Dict[str, torch.Tensor]:
    """An upstream HiFi-GAN ``g_*`` state dict (weight-normed torch
    modules) -> this ``Generator``'s state dict: the same layouts, the
    names of the JAX package's converter, ``g`` flattened. Accepts numpy
    arrays or tensors."""
    def t(key):
        return torch.as_tensor(np.asarray(
            state_dict[key].detach().cpu().numpy()
            if hasattr(state_dict[key], "detach") else state_dict[key]))

    sd: Dict[str, torch.Tensor] = {}

    def conv(ours, base):
        sd[f"{ours}_v"] = t(f"{base}.weight_v")
        sd[f"{ours}_g"] = t(f"{base}.weight_g").reshape(-1)
        sd[f"{ours}_bias"] = t(f"{base}.bias")

    for ours, base in _upstream_names(config):
        conv(ours, base)
    return sd


def _upstream_names(config: HiFiGANConfig):
    """(this module's conv name, the upstream module's) pairs, as the JAX
    package's converter pairs them (ResBlock1's convs1 and convs2)."""
    names = [("conv_pre", "conv_pre"), ("conv_post", "conv_post")]
    for i in range(len(config.upsample_rates)):
        names.append((f"up_{i}", f"ups.{i}"))
        for j in range(len(config.resblock_kernel_sizes)):
            for li in range(len(config.resblock_dilation_sizes[j])):
                names += [(f"resblock_{i}_{j}.{ours}_{li}",
                           f"resblocks.{i}.{j}.{cname}.{li}")
                          for cname, ours in (("convs1", "c1"),
                                              ("convs2", "c2"))]
    return names


def upstream_generator_state_dict(gen: Generator) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_torch_generator_params``: ``gen``'s weights
    on the host under the upstream module names, ``weight_g`` shaped
    (C, 1, 1), as a ``g_*`` file holds them under ``"generator"``."""
    sd = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    out = {}
    for ours, base in _upstream_names(gen.config):
        out[f"{base}.weight_v"] = sd[f"{ours}_v"]
        out[f"{base}.weight_g"] = sd[f"{ours}_g"].reshape(-1, 1, 1)
        out[f"{base}.bias"] = sd[f"{ours}_bias"]
    return out
