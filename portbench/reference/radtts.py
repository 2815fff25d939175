"""What RAD-TTS on LJSpeech (``configs/radtts_ljs.json``) needs beyond the
frozen reference of ``reference/frozen``, in the same plain PyTorch: the
duration predictor with an LSTM-first backbone (``LSTMConv``,
``LSTMConvDAP``), a ``TTSModel`` that builds it, and the featurizer's
cached-F0 branch. Everything else is imported from ``reference/frozen``.

RAD-TTS (Shih et al., ICML 2021 INNF+ workshop; github.com/NVIDIA/radtts)
predicts a token's duration from the text encodings with a BiLSTM followed
by three convolutions, the last one without an activation; its F0, energy
and voicing predictors are the frozen ``ConvLSTMLinearDAP``. Departures
from the published description, shared with the port:

- the convolutions are weight-normed and masked (``MaskedConv1d``), and
  the BiLSTM spectral-normed, as in NVIDIA/RAD-MMM's
  ``attribute_prediction_model.py``;
- dropout follows every backbone convolution but the last, drawn from the
  caller's generator (the upstream code draws from torch's global RNG);
- the predictor is conditioned on the speaker alone; the accent embedding
  it is handed is ignored, as upstream;
- the port's batch norms in ``LSTMConv`` (``use_bn``) are not copied: the
  configuration leaves them off;
- the F0 track comes from a cache of pYIN's output computed before the
  step ([f0 Hz, voiced, p_voiced] a frame), in place of pYIN inside the
  featurizer; both sides of the comparison read the same cache.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from portbench.reference.frozen.data import collate
from portbench.reference.frozen.models import tts
from portbench.reference.frozen.models.attributes import (BottleneckLayer,
                                                          tx_target)
from portbench.reference.frozen.ops.conv import MaskedConv1d, dropout
from portbench.reference.frozen.ops.lstm import MaskedLSTM
from portbench.reference.frozen.utils.masking import SeqLens

TTSConfig = tts.TTSConfig


class LSTMConv(nn.Module):
    """BiLSTM first, then a conv stack whose last conv has no
    activation."""

    def __init__(self, in_dim: int, out_dim: int, n_layers: int = 3,
                 n_channels: int = 512, kernel_size: int = 3,
                 p_dropout: float = 0.1,
                 lstm_norm_fn: Optional[str] = "spectral"):
        super().__init__()
        if n_channels % 2:
            raise ValueError("LSTMConv needs an even n_channels")
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        self.lstm = MaskedLSTM(in_dim, n_channels // 2, bidirectional=True,
                               spectral_norm=(lstm_norm_fn is not None
                                              and "spectral" in lstm_norm_fn))
        for i in range(n_layers):
            out_ch = out_dim if i == n_layers - 1 else n_channels
            setattr(self, f"conv_{i}", MaskedConv1d(
                n_channels, out_ch, kernel_size, w_init_gain="relu",
                use_weight_norm=True))

    def forward(self, x, lens: SeqLens, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.lstm(x, lens.mask, update_sn=train)
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x, lens.mask)
            if i < self.n_layers - 1:
                x = dropout(torch.relu(x), self.p_dropout,
                            generator if train else None)
        return x


class LSTMConvDAP(nn.Module):
    """The duration predictor: bottleneck, the speaker vector broadcast
    over the tokens, then ``LSTMConv``; its target transform is the plain
    scale, offset and log. (The port's ``infer`` is not copied: the
    benchmark trains this configuration and serves none.)"""

    def __init__(self, n_speaker_dim: int = 16, in_dim: int = 512,
                 out_dim: int = 1, reduction_factor: int = 16,
                 n_backbone_layers: int = 2, n_hidden: int = 256,
                 kernel_size: int = 3, p_dropout: float = 0.25,
                 target_scale: float = 1.0, target_offset: float = 0.0,
                 log_target: bool = False,
                 lstm_norm_fn: Optional[str] = "spectral"):
        super().__init__()
        self._tx_kwargs = dict(target_scale=target_scale,
                               target_offset=target_offset,
                               log_target=log_target)
        self.bottleneck = BottleneckLayer(in_dim, reduction_factor)
        self.backbone = LSTMConv(self.bottleneck.out_dim + n_speaker_dim,
                                 out_dim, n_backbone_layers, n_hidden,
                                 kernel_size, p_dropout,
                                 lstm_norm_fn=lstm_norm_fn)

    def forward(self, text_enc, spk_emb, lens: SeqLens, x_mean=None,
                x_std=None, accent_emb=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x_hat (B, T, out_dim) in the transformed target space."""
        h = self.bottleneck(text_enc, lens.mask)
        B, T = h.shape[0], text_enc.shape[1]
        h = torch.cat([h, spk_emb[:, None, :].expand(B, T, -1)], dim=-1)
        return self.backbone(h, lens, train=train, generator=generator)

    def targets(self, x, x_mean=None, x_std=None):
        return tx_target(x, **self._tx_kwargs)


class TTSModel(tts.TTSModel):
    """The frozen ``TTSModel`` whose predictors may also be
    ``LSTMConvDAP`` (a predictor config's ``_class``), registered in the
    frozen model's order, so parameters come in the port's order."""

    def __init__(self, config: TTSConfig):
        lstm_first = {a: dict(getattr(config, a)) for a in tts._PREDICTORS
                      if (getattr(config, a) or {}).get("_class")
                      == "LSTMConvDAP"}
        super().__init__(TTSConfig(**{**config.__dict__,
                                      **{a: None for a in lstm_first}}))
        self.config = config
        for attr in tts._PREDICTORS:
            m = getattr(self, attr)
            if attr in lstm_first:
                lstm_first[attr].pop("_class")
                m = LSTMConvDAP(**lstm_first[attr])
            self.__dict__.pop(attr, None)
            self._modules.pop(attr, None)
            setattr(self, attr, m)


class Featurizer(collate.Featurizer):
    """The frozen featurizer's cached-F0 branch: a raw batch carries
    ``cached_f0`` (B, 3, frames), from which the F0, voicing and voicing
    probability are taken; pYIN does not run."""

    def featurize_raw(self, raw: Dict[str, torch.Tensor],
                      noise_key: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        audio = raw["audio_i16"].to(torch.float32) / 32768.0
        mel, mel_lens, f0, voiced, p_voiced, energy, prior = self._cached(
            audio, raw["audio_lengths"], raw["input_lengths"],
            int(raw["text"].shape[1]), raw["cached_f0"])
        batch = {k: v for k, v in raw.items()
                 if k not in ("audio_i16", "cached_f0")}
        batch["audio"] = audio
        batch.update(mel=mel, output_lengths=mel_lens, f0=f0,
                     voiced_mask=voiced, p_voiced=p_voiced,
                     energy_avg=energy, attn_prior=prior)
        return batch

    def _cached(self, audio, audio_lens, text_lens, max_text: int,
                cached_f0):
        """The frozen ``_featurize`` with the tracks read from
        ``cached_f0``."""
        hop = self.hop_length
        mel = self.mel(audio)[:, :audio.shape[1] // hop]
        n = mel.shape[1]
        mel_lens = torch.clamp(1 + audio_lens // hop, max=n).to(torch.int32)
        f0, voiced, p_voiced = (cached_f0[:, i, :n] for i in range(3))
        if self.use_log_f0:
            f0 = torch.where(f0 >= self.f0_min,
                             torch.log(torch.clamp_min(f0, 1.0)), 0.0)
        energy = mel.mean(dim=-1)
        if self.use_scaled_energy:
            energy = (energy + 20.0) / 20.0
        frame_mask = (torch.arange(n, device=mel.device)[None, :]
                      < mel_lens[:, None]).to(mel.dtype)
        mel = mel * frame_mask[..., None]
        f0, voiced, energy = (t * frame_mask for t in (f0, voiced, energy))
        if self.use_attn_prior_masking:
            prior = collate.beta_binomial_prior(
                text_lens, mel_lens, max_text=max_text, max_mel=n,
                scaling_factor=self.betabinom_scaling_factor)
        else:
            prior = torch.ones((audio.shape[0], n, max_text),
                               device=mel.device)
        return mel, mel_lens, f0, voiced, p_voiced, energy, prior
