"""Deterministic attribute predictors (F0 / energy / voiced / duration).

Counterpart of ``radmmm_tpu/models/attributes.py`` (``BottleneckLayer``,
``ConvLSTMLinear``, ``ConvLSTMLinearDAP`` and the target transforms; the
port's other backbones are not copied: no configuration of the benchmark
builds them). A bottleneck conv compresses the text encodings, speaker
(and accent) vectors are broadcast over time and concatenated, then a
conv -> BiLSTM -> linear backbone predicts the attribute. In training
(``train=True``) each backbone conv ends in dropout drawn from the
caller's generator, the BiLSTM's spectral norms update their ``u``, and
``targets`` maps the ground truth into the space the predictor regresses
in (``tx_target``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.ops.conv import Linear, MaskedConv1d, dropout
from portbench.reference.frozen.ops.lstm import MaskedLSTM
from portbench.reference.frozen.utils.masking import SeqLens


def tx_target(x, target_scale=1.0, target_offset=0.0, log_target=False,
              normalize_target=False, normalization_type=None,
              x_mean=None, x_std=None):
    """Forward target transform. x: (B, T, 1); x_mean/x_std: (B,)."""
    if normalize_target:
        if normalization_type is None:
            raise ValueError("normalize_target needs a normalization_type")
        if normalization_type == "norm_lin_space":
            # the JAX package's expression verbatim: x - mean/std
            x = x - (x_mean / x_std)[:, None, None]
            x = torch.log(x + 10.0) / 3.0
        elif normalization_type == "norm_log_space":
            x = (x - x_mean[:, None, None]) / x_std[:, None, None]
            x = (x + 5.0) / 10.0
        return x
    x = x * target_scale + target_offset
    if log_target:
        x = torch.log(x + 1.0)
    return x


def inv_tx_target(x, target_scale=1.0, target_offset=0.0, log_target=False,
                  normalize_target=False, normalization_type=None,
                  x_mean=None, x_std=None):
    """Inverse target transform."""
    if normalize_target and x_mean is not None and x_std is not None:
        if normalization_type == "norm_lin_space":
            x = torch.exp(x * 3.0) - 10.0
            return x * x_std[:, None, None] + x_mean[:, None, None]
        if normalization_type == "norm_log_space":
            x = x * 10.0 - 5.0
            return x * x_std[:, None, None] + x_mean[:, None, None]
        return x
    if log_target:
        x = torch.exp(x) - 1.0
    return (x - target_offset) / target_scale


class BottleneckLayer(nn.Module):
    """Dimension-reducing conv + nonlinearity."""

    def __init__(self, in_dim: int, reduction_factor: int = 16,
                 kernel_size: int = 3, non_linearity: str = "leakyrelu"):
        super().__init__()
        self.reduction_factor = reduction_factor
        self.non_linearity = non_linearity
        self.out_dim = (in_dim // reduction_factor if reduction_factor > 1
                        else in_dim)
        if reduction_factor > 1:
            # premask_input=False: the conv reads the padded frame after the
            # last valid one, as the JAX module (and its reference) does
            self.proj = MaskedConv1d(in_dim, self.out_dim, kernel_size,
                                     use_weight_norm=True,
                                     premask_input=False)

    def forward(self, x, mask=None):
        if self.reduction_factor > 1:
            x = self.proj(x, mask)
            x = (F.leaky_relu(x, 0.01) if self.non_linearity == "leakyrelu"
                 else torch.relu(x))
        return x


class ConvLSTMLinear(nn.Module):
    """conv stack -> (Bi)LSTM (spectral norm) -> linear."""

    def __init__(self, in_dim: int, out_dim: int, n_layers: int = 2,
                 n_channels: int = 256, kernel_size: int = 3,
                 p_dropout: float = 0.1,
                 lstm_type: Optional[str] = "bilstm", use_linear: bool = True,
                 spectral_norm: bool = True):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        self.use_linear = use_linear
        n_channels = n_channels if use_linear else out_dim
        for i in range(n_layers):
            setattr(self, f"conv_{i}", MaskedConv1d(
                in_dim if i == 0 else n_channels, n_channels, kernel_size,
                w_init_gain="relu", use_weight_norm=True))
        self.lstm = None
        if lstm_type:
            bi = lstm_type == "bilstm"
            self.lstm = MaskedLSTM(n_channels,
                                   n_channels // 2 if bi else n_channels,
                                   bidirectional=bi,
                                   spectral_norm=spectral_norm)
        if use_linear:
            self.dense = Linear(n_channels, out_dim)

    def forward(self, x, lens: SeqLens, phase: str = "all",
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """phase 'all' runs the whole stack; 'pre' runs the convs and
        returns (conv_out, stacked LSTM weights) so the caller can gang
        several same-shape BiLSTMs into one launch; 'post' takes the LSTM
        output and applies the output linear."""
        if phase in ("all", "pre"):
            for i in range(self.n_layers):
                x = torch.relu(getattr(self, f"conv_{i}")(x, lens.mask))
                x = dropout(x, self.p_dropout, generator if train else None)
            if phase == "pre":
                return x, (self.lstm.weights(update_sn=train)
                           if self.lstm is not None else None)
            if self.lstm is not None:
                x = self.lstm(x, lens.mask, update_sn=train)
        if self.use_linear:
            x = self.dense(x)
        return x


class ConvLSTMLinearDAP(nn.Module):
    """Deterministic attribute predictor; ``infer`` applies the inverse
    target transform."""

    def __init__(self, n_speaker_dim: int = 16, n_accent_dim: int = 0,
                 in_dim: int = 512, out_dim: int = 1,
                 reduction_factor: int = 16, n_backbone_layers: int = 2,
                 n_hidden: int = 256, kernel_size: int = 3,
                 p_dropout: float = 0.25, target_scale: float = 1.0,
                 target_offset: float = 0.0, log_target: bool = False,
                 lstm_type: Optional[str] = "bilstm",
                 use_speaker_embedding: bool = True,
                 use_accent_embedding: bool = False,
                 normalize_target: bool = False,
                 normalization_type: Optional[str] = None):
        super().__init__()
        self.n_hidden = n_hidden
        self.lstm_type = lstm_type
        self.use_speaker_embedding = use_speaker_embedding
        self.use_accent_embedding = use_accent_embedding
        self._tx_kwargs = dict(target_scale=target_scale,
                               target_offset=target_offset,
                               log_target=log_target,
                               normalize_target=normalize_target,
                               normalization_type=normalization_type)
        self.bottleneck = BottleneckLayer(in_dim, reduction_factor)
        backbone_in = (self.bottleneck.out_dim
                       + (n_speaker_dim if use_speaker_embedding else 0)
                       + (n_accent_dim if use_accent_embedding else 0))
        self.backbone = ConvLSTMLinear(backbone_in, out_dim,
                                       n_backbone_layers, n_hidden,
                                       kernel_size, p_dropout, lstm_type)

    def forward(self, text_enc, spk_emb, lens: SeqLens, accent_emb=None,
                phase: str = "all", lstm_out=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns x_hat (B, T, out_dim) in the transformed target space.
        phase='pre' returns {'conv', 'lstm'} for a ganged recurrence and
        phase='post' consumes its output ``lstm_out``."""
        if phase == "post":
            return self.backbone(lstm_out, lens, phase="post")
        h = self.bottleneck(text_enc, lens.mask)
        B, T = h.shape[0], text_enc.shape[1]
        parts = [h]
        if self.use_speaker_embedding:
            parts.append(spk_emb[:, None, :].expand(B, T, -1))
        if self.use_accent_embedding:
            parts.append(accent_emb[:, None, :].expand(B, T, -1))
        h = torch.cat(parts, dim=-1)
        if phase == "pre":
            conv, ws = self.backbone(h, lens, phase="pre", train=train,
                                     generator=generator)
            return {"conv": conv, "lstm": ws}
        return self.backbone(h, lens, train=train, generator=generator)

    def targets(self, x, x_mean=None, x_std=None):
        """Ground truth (B, T, 1) in the predictor's target space."""
        return tx_target(x, x_mean=x_mean, x_std=x_std, **self._tx_kwargs)

    def infer(self, text_enc, spk_emb, lens: SeqLens, x_mean=None,
              x_std=None, accent_emb=None):
        return self.inv_tx(self(text_enc, spk_emb, lens,
                                accent_emb=accent_emb), x_mean, x_std)

    def inv_tx(self, x_hat, x_mean=None, x_std=None):
        return inv_tx_target(x_hat, x_mean=x_mean, x_std=x_std,
                             **self._tx_kwargs)
