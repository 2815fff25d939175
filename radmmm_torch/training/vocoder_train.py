"""Vocoder training: HiFi-GAN GAN steps and WaveGlow maximum likelihood.

Counterpart of ``radmmm_tpu/training/vocoder_train.py``:

* generator loss = adversarial (least squares) + feature matching
  (``feature_loss`` doubles it, the trainer scales it by
  ``feature_loss_weight / 2``) + 45 x the L1 of the full-band log-mel
  (``mel_fmax_loss`` None);
* discriminator loss = least squares on real and generated audio through
  the MPD (periods 2, 3, 5, 7, 11) and the MSD (3 scales);
* one step updates the discriminators on the generated audio, detached,
  then the generator through the *updated* discriminators;
* AdamW (b1 0.8, b2 0.99, optax's weight decay 1e-4, not torch's 1e-2)
  at a constant learning rate: ``lr_decay`` is in the config, as in the
  JAX package, and nothing reads it; WaveGlow trains with Adam (optax's
  defaults, no weight decay). Both are the port's ``training/optim.
  Optimizer`` with no clip, in optax's order;
* ``random_segments``: random fixed-length audio crops, their starts
  rounded down to a multiple of the hop, with their mel windows.

The JAX package jits each ``train_step`` with its state donated. Here a
step runs through ``utils/graphs.Graphed`` in the trainer's pool: on the
card one CUDA graph per batch shape (and, for HiFi-GAN with ``blur_p``,
per branch: blurred or not), warmed up at its first step, captured at its
second, replayed after. The host's half stays outside the graph: the
optimizers' ``prepare`` (the step's bias corrections), the blur's two
draws (the chosen kernel goes in as an input tensor) and the step count.
The crops' mels are computed inside the graph when the batch carries
audio alone (``vocoder_fit``'s batches, ``random_crops``). With
``pool=None`` the step runs eagerly; on the CPU it always does.

A trainer holds its modules and optimizers on its device and counts its
steps; ``state_dict`` / ``load_state_dict`` carry all of it, on the host,
through a checkpoint. A checkpoint written before the trainers took the
port's ``Optimizer`` holds ``torch.optim`` state dicts of the same
moments, which ``Optimizer.load_state_dict`` still reads.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from radmmm_torch.ops.stft import MelSpectrogram
from radmmm_torch.training.optim import Optimizer
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import (OWN_POOL, GraphPool, graph_program,
                                       own_pool)
from radmmm_torch.vocoder.hifigan import (Generator, HiFiGANConfig,
                                          MultiPeriodDiscriminator,
                                          MultiScaleDiscriminator,
                                          blur_draws, blur_generator,
                                          blur_mel, discriminator_loss,
                                          feature_loss,
                                          gaussian_blur_kernels,
                                          generator_adv_loss)
from radmmm_torch.vocoder.waveglow import WaveGlow, waveglow_loss

# optax.adamw's default weight decay
ADAMW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class VocoderTrainConfig:
    segment_size: int = 8192
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    mel_loss_weight: float = 45.0
    feature_loss_weight: float = 2.0
    sampling_rate: int = 22050
    n_mel_channels: int = 80
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_fmax: Optional[float] = 8000.0
    mel_fmax_loss: Optional[float] = None   # full-band mel for the loss
    # the generator's input blurred with probability blur_p by a 2-D
    # Gaussian of a random sigma (GaussianBlurAugmentation,
    # hifigan_models.py:56-101)
    blur_p: float = 0.0
    blur_kernel_size: Tuple[int, int] = (5, 5)
    blur_sigmas: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)
    seed: int = 0


def _host(obj):
    """Tensors (nested in dicts and lists) detached onto the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _seeded(build, seed: int):
    """``build()`` with the global CPU generator seeded from ``seed``,
    the caller's stream left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _graphed(trainer, pool: Union[GraphPool, str, None], name: str):
    """The trainer's step's device half, ``trainer._device_step(inputs)``
    -> its metrics, as (pool, ``step(inputs, key=())``): through
    ``Graphed`` in ``pool`` (``OWN_POOL``: a new one), or eager where
    ``pool`` is None. The step holds the trainer weakly: the trainer holds
    the step, and a cycle would keep its graphs' memory until the cyclic
    collector ran."""
    ref = weakref.ref(trainer)

    def run(inputs):
        return ref()._device_step(inputs)

    pool = own_pool(pool)
    return pool, graph_program(run, pool, name)


def segment_mels(mel_fn: MelSpectrogram, segs: torch.Tensor,
                 segment_size: int) -> torch.Tensor:
    """The crops' mels, trimmed to ``segment_size // hop`` frames."""
    return mel_fn(segs)[:, :segment_size // mel_fn.hop_length]


class HiFiGANTrainer:
    METRICS = ("disc_loss", "gen_loss", "gen_adv", "gen_fm", "gen_mel")

    def __init__(self, gen_config: HiFiGANConfig,
                 cfg: VocoderTrainConfig = VocoderTrainConfig(),
                 device: str | torch.device = "cuda", seed: int = 0,
                 pool: Union[GraphPool, str, None] = OWN_POOL):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gen, self.mpd, self.msd = (
            m.to(self.device) for m in _seeded(lambda: (
                Generator(gen_config), MultiPeriodDiscriminator(),
                MultiScaleDiscriminator()), seed))
        self.mel_loss_fn = MelSpectrogram(
            cfg.filter_length, cfg.hop_length, cfg.win_length,
            cfg.n_mel_channels, cfg.sampling_rate, 0.0, cfg.mel_fmax_loss)
        self.gen_params = list(self.gen.parameters())
        self.gen_opt = self._adamw(self.gen_params)
        self.disc_opt = self._adamw(list(self.mpd.parameters())
                                    + list(self.msd.parameters()))
        self.blur_kernels = (gaussian_blur_kernels(cfg.blur_kernel_size,
                                                   cfg.blur_sigmas)
                             if cfg.blur_p > 0 else None)
        # the bank on the device: a step's kernel is a row of it
        self._blur_bank = (self.blur_kernels.to(self.device)
                           if self.blur_kernels is not None else None)
        self.step = 0
        self.pool, self._step_fn = _graphed(self, pool, "hifigan_step")

    def _adamw(self, params):
        return Optimizer(params, "Adam", self.cfg.learning_rate,
                         weight_decay=ADAMW_WEIGHT_DECAY,
                         b1=self.cfg.adam_b1, b2=self.cfg.adam_b2, eps=1e-8)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One GAN step: the discriminators' update, then the
        generator's. ``batch``: the crops' ``audio`` and, optionally, their
        ``mel`` (else computed in the step). -> metrics (0-d tensors on
        the device)."""
        cfg = self.cfg
        inputs = {k: batch[k] for k in ("audio", "mel") if k in batch}
        blurred = False
        if self._blur_bank is not None:
            # the generator's input, blurred once a step by a kernel drawn
            # here; the mel-loss target stays the clean data mel
            i, blurred = blur_draws(blur_generator(cfg.seed, self.step),
                                    self._blur_bank.shape[0], cfg.blur_p)
            if blurred:
                inputs["kernel"] = self._blur_bank[i]
        self.disc_opt.prepare()
        self.gen_opt.prepare()
        values = self._step_fn(inputs, key=(blurred,))
        self.step += 1
        return dict(zip(self.METRICS, values.unbind()))

    def _device_step(self, inputs) -> torch.Tensor:
        """The step's device work, after both optimizers' ``prepare``."""
        cfg = self.cfg
        audio = inputs["audio"]
        mel = inputs.get("mel")
        if mel is None:
            mel = segment_mels(self.mel_loss_fn, audio, audio.shape[1])
        if "kernel" in inputs:
            mel = blur_mel(mel, inputs["kernel"])
        y_hat = self.gen(mel)

        # discriminators, on the generated audio without its gradient
        y_sg = y_hat.detach()
        pr, pg, _, _ = self.mpd(audio, y_sg)
        sr, sg, _, _ = self.msd(audio, y_sg)
        d_loss = discriminator_loss(pr, pg) + discriminator_loss(sr, sg)
        self.disc_opt.zero_grad()
        d_loss.backward()
        self.disc_opt.apply()

        # generator, through the updated discriminators; y_hat's graph is
        # the one the JAX step recomputes with the same parameters
        loss_mel = torch.mean(torch.abs(self.mel_loss_fn(y_hat)
                                        - self.mel_loss_fn(audio)))
        pr, pg, fr, fg = self.mpd(audio, y_hat)
        sr, sg, fr2, fg2 = self.msd(audio, y_hat)
        loss_adv = generator_adv_loss(pg) + generator_adv_loss(sg)
        loss_fm = feature_loss(fr, fg) + feature_loss(fr2, fg2)
        total = (loss_adv + cfg.feature_loss_weight / 2.0 * loss_fm
                 + cfg.mel_loss_weight * loss_mel)
        self.gen_opt.zero_grad()
        # gradients into the generator only: the discriminators' next step
        # starts from none
        total.backward(inputs=self.gen_params)
        self.gen_opt.apply()
        return torch.stack([d_loss, total, loss_adv, loss_fm,
                            loss_mel]).detach()

    def state_dict(self) -> Dict[str, Any]:
        return _host({"step": self.step, "gen": self.gen.state_dict(),
                      "mpd": self.mpd.state_dict(),
                      "msd": self.msd.state_dict(),
                      "gen_opt": self.gen_opt.state_dict(),
                      "disc_opt": self.disc_opt.state_dict()})

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        for key in ("gen", "mpd", "msd", "gen_opt", "disc_opt"):
            getattr(self, key).load_state_dict(payload[key])
        self.step = int(payload["step"])


class WaveGlowTrainer:
    """Maximum-likelihood WaveGlow training (the vendored tree's
    train.py): the flow NLL of random audio segments and their mel
    windows, Adam at ``cfg.learning_rate``."""

    def __init__(self, waveglow_config: Optional[Dict[str, Any]],
                 cfg: VocoderTrainConfig = VocoderTrainConfig(),
                 sigma: float = 1.0, device: str | torch.device = "cuda",
                 seed: int = 0,
                 pool: Union[GraphPool, str, None] = OWN_POOL):
        self.device = resolve_device(device)
        kw = dict(hop_length=cfg.hop_length,
                  n_mel_channels=cfg.n_mel_channels)
        kw.update(waveglow_config or {})
        self.model = _seeded(lambda: WaveGlow(**kw), seed).to(self.device)
        self.cfg = cfg
        self.sigma = sigma
        self.mel_loss_fn = MelSpectrogram(
            cfg.filter_length, cfg.hop_length, cfg.win_length,
            cfg.n_mel_channels, cfg.sampling_rate, 0.0, cfg.mel_fmax)
        self.opt = Optimizer(self.model.parameters(), "Adam",
                             cfg.learning_rate, eps=1e-8)
        self.step = 0
        self.pool, self._step_fn = _graphed(self, pool, "waveglow_step")

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step of the NLL; ``batch`` as ``HiFiGANTrainer``'s."""
        self.opt.prepare()
        loss = self._step_fn({k: batch[k] for k in ("audio", "mel")
                              if k in batch})
        self.step += 1
        return {"gen_loss": loss, "nll": loss}

    def _device_step(self, inputs) -> torch.Tensor:
        audio = inputs["audio"]
        mel = inputs.get("mel")
        if mel is None:
            mel = segment_mels(self.mel_loss_fn, audio, audio.shape[1])
        loss = waveglow_loss(self.model(audio, mel), sigma=self.sigma)
        self.opt.zero_grad()
        loss.backward()
        self.opt.apply()
        return loss.detach()

    def state_dict(self) -> Dict[str, Any]:
        return _host({"step": self.step, "model": self.model.state_dict(),
                      "opt": self.opt.state_dict()})

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        self.model.load_state_dict(payload["model"])
        self.opt.load_state_dict(payload["opt"])
        self.step = int(payload["step"])


def random_segments(audio: np.ndarray, audio_lens: np.ndarray,
                    mel_fn: MelSpectrogram, segment_size: int,
                    rng: np.random.Generator,
                    device: str | torch.device = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Random fixed-length crops of the host batch's audio, their starts
    rounded down to a multiple of the hop, and their mels trimmed to
    ``segment_size // hop`` frames, on ``device``."""
    segs = random_crops(audio, audio_lens, mel_fn.hop_length, segment_size,
                        rng, device)
    return {"audio": segs, "mel": segment_mels(mel_fn, segs, segment_size)}


def random_crops(audio: np.ndarray, audio_lens: np.ndarray, hop: int,
                 segment_size: int, rng: np.random.Generator,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """``random_segments``'s crops alone, (B, segment_size) on
    ``device``: the same draws from ``rng``."""
    B = audio.shape[0]
    segs = np.zeros((B, segment_size), np.float32)
    for b in range(B):
        max_start = max(int(audio_lens[b]) - segment_size, 0)
        start = int(rng.integers(0, max_start + 1)) if max_start > 0 else 0
        start = (start // hop) * hop
        chunk = audio[b, start:start + segment_size]
        segs[b, :len(chunk)] = chunk
    return torch.from_numpy(segs).to(device)
