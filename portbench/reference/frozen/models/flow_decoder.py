"""RADMMM normalizing-flow mel decoder.

Counterpart of ``radmmm_tpu/models/flow_decoder.py`` (``squeeze_time``,
``unsqueeze_time``, ``RADMMMFlow.preprocess_context``, ``RADMMMFlow.forward``
and ``RADMMMFlow.infer``). Context: the aligned text states squeezed in time
by n_group_size, the speaker vector and the F0/energy channels, through a
context BiLSTM. Training (``forward``): mel -> z through the flow steps,
each a 1x1 mix then an affine coupling, with n_early_size channels leaving
every n_early_every steps; it returns z and every step's log s and
log|det W|. Sampling: z ~ N(0, sigma²) (drawn from an explicit
``torch.Generator``) runs through the flow steps in reverse, each a
coupling inverse followed by the 1x1 inverse, with the early-exit
channels re-inserted where the forward direction split them off. (The
port's spline steps, ``n_splines``, are not copied: no configuration of
the benchmark builds them.)

The squeeze keeps the channel-major nn.Unfold order (index = c*g + k).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference.frozen.ops.coupling import AffineCoupling
from portbench.reference.frozen.ops.invertible import InvertibleLU, WhiteningConv
from portbench.reference.frozen.ops.length_regulator import regulate_length
from portbench.reference.frozen.ops.lstm import MaskedLSTM
from portbench.reference.frozen.utils.masking import SeqLens


def squeeze_time(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, C) -> (B, T//g, C*g), channel-major group layout."""
    if g == 1:
        return x
    B, T, C = x.shape
    x = x[:, :(T // g) * g].reshape(B, T // g, g, C)
    return x.transpose(2, 3).reshape(B, T // g, C * g)


def unsqueeze_time(x: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of squeeze_time."""
    if g == 1:
        return x
    B, Tg, Cg = x.shape
    x = x.reshape(B, Tg, Cg // g, g)
    return x.transpose(2, 3).reshape(B, Tg * g, Cg // g)


class FlowStep(nn.Module):
    """Invertible 1x1 + an affine coupling."""

    def __init__(self, n_channels: int, n_context_dim: int, n_layers: int,
                 step_index: int, mode: str = "LUS",
                 affine_model: str = "wavenet", scaling_fn: str = "tanh",
                 affine_activation: str = "softplus",
                 use_partial_padding: bool = True):
        super().__init__()
        self.invtbl_conv = (WhiteningConv(n_channels, init_seed=step_index)
                            if mode == "whiten"
                            else InvertibleLU(n_channels,
                                              init_seed=step_index))
        self.coupling = AffineCoupling(
            n_channels, n_context_dim, n_layers,
            affine_model=affine_model, scaling_fn=scaling_fn,
            affine_activation=affine_activation,
            use_partial_padding=use_partial_padding)

    def forward(self, z, context, mask=None, train: bool = True):
        """(z', log|det W|, log s)."""
        z, log_det_W = self.invtbl_conv(z)
        z, log_s = self.coupling(z, context, mask, train=train)
        return z, log_det_W, log_s

    def inverse(self, z, context, mask=None, train: bool = False):
        z = self.coupling.inverse(z, context, mask, train=train)
        return self.invtbl_conv.inverse(z)


class RADMMMFlow(nn.Module):
    """Bipartite flow decoder P(mel | text, speaker, accent, F0, energy)."""

    def __init__(self, n_speaker_dim: int = 16, use_accent: bool = True,
                 n_accent_dim: int = 8, n_text_dim: int = 512,
                 n_group_size: int = 2, n_mel_channels: int = 80,
                 n_f0_dims: int = 1, n_energy_avg_dims: int = 1,
                 context_w_f0_and_energy: bool = True,
                 use_context_lstm: bool = True,
                 context_lstm_norm: Optional[str] = None, n_flows: int = 8,
                 n_conv_layers_per_step: int = 4, n_early_size: int = 2,
                 n_early_every: int = 2, affine_model: str = "wavenet",
                 scaling_fn: str = "tanh",
                 affine_activation: str = "softplus",
                 use_partial_padding: bool = True,
                 use_accent_emb_for_decoder: bool = False):
        super().__init__()
        del use_accent   # JAX-only
        if n_speaker_dim % 2 or n_early_size % 2:
            raise ValueError("n_speaker_dim and n_early_size must be even")
        g = n_group_size
        self.n_group_size = g
        self.n_mel_channels = n_mel_channels
        self.n_f0_dims = n_f0_dims
        self.n_energy_avg_dims = n_energy_avg_dims
        self.context_w_f0_and_energy = context_w_f0_and_energy
        self.use_accent_emb_for_decoder = use_accent_emb_for_decoder
        self.n_flows = n_flows
        self.n_early_size = n_early_size
        self.n_early_every = n_early_every
        acc = n_accent_dim if use_accent_emb_for_decoder else 0
        ctx_in = n_text_dim * g + n_speaker_dim + acc
        if context_w_f0_and_energy:
            ctx_in += (n_f0_dims + n_energy_avg_dims) * g
        if use_context_lstm:
            hidden = (n_speaker_dim + n_text_dim * g + acc) // 2
            self.context_lstm = MaskedLSTM(
                ctx_in, hidden, bidirectional=True,
                spectral_norm=(context_lstm_norm is not None
                               and "spectral" in context_lstm_norm))
            cond_dims = 2 * hidden
        else:
            self.context_lstm = None
            cond_dims = ctx_in
        self.flows = nn.ModuleList([
            FlowStep(c, cond_dims, n_conv_layers_per_step, step_index=i,
                     mode=("whiten" if i == 0 else "LUS"),
                     affine_model=affine_model, scaling_fn=scaling_fn,
                     affine_activation=affine_activation,
                     use_partial_padding=use_partial_padding)
            for i, c in enumerate(self._flow_channel_sizes())])

    @property
    def exit_steps(self):
        return [i for i in range(1, self.n_flows)
                if i % self.n_early_every == 0]

    def _flow_channel_sizes(self):
        sizes = []
        c = self.n_mel_channels * self.n_group_size
        for i in range(self.n_flows):
            if i > 0 and i % self.n_early_every == 0:
                c -= self.n_early_size
            sizes.append(c)
        return sizes

    def preprocess_context(self, context, spk_vecs, lens: SeqLens, f0=None,
                           energy_avg=None, accent_vecs=None,
                           train: bool = False):
        g = self.n_group_size
        context = squeeze_time(context, g)
        B, T = context.shape[:2]
        parts = [context, spk_vecs[:, None, :].expand(B, T, -1)]
        if self.use_accent_emb_for_decoder:
            if accent_vecs is None:
                raise ValueError("this decoder needs accent vectors")
            parts.append(accent_vecs[:, None, :].expand(B, T, -1))
        if self.context_w_f0_and_energy:
            if f0 is not None and self.n_f0_dims > 0:
                parts.append(squeeze_time(f0[..., None], g))
            if energy_avg is not None and self.n_energy_avg_dims > 0:
                parts.append(squeeze_time(energy_avg[..., None], g))
        ctx = torch.cat(parts, dim=-1)
        if self.context_lstm is not None:
            ctx = self.context_lstm(ctx, lens.downsample(g).mask,
                                    update_sn=train)
        return ctx

    def forward(self, mel, spk_vecs, context, lens: SeqLens, f0=None,
                energy_avg=None, accent_vecs=None, train: bool = True):
        """Training direction mel -> z. mel (B, T, n_mel); context
        (B, T, n_text_dim), aligned to the mel frames. Returns {'z_mel'
        (B, T//g, n_mel*g), 'log_det_W_list', 'log_s_list',
        'context_w_spkvec'}."""
        ctx = self.preprocess_context(context, spk_vecs, lens, f0,
                                      energy_avg, accent_vecs, train=train)
        g = self.n_group_size
        z = squeeze_time(mel, g)
        mask = lens.downsample(g).mask
        z_out, log_s_list, log_det_W_list = [], [], []
        exits = set(self.exit_steps)
        for i, step in enumerate(self.flows):
            if i in exits:
                z_out.append(z[..., :self.n_early_size])
                z = z[..., self.n_early_size:]
            z, log_det_W, log_s = step(z, ctx, mask, train=train)
            log_s_list.append(log_s)
            log_det_W_list.append(log_det_W)
        z_out.append(z)
        return {"z_mel": torch.cat(z_out, dim=-1),
                "log_det_W_list": log_det_W_list, "log_s_list": log_s_list,
                "context_w_spkvec": ctx}

    def draw_residual(self, batch: int, max_frames: int, sigma: float,
                      generator: Optional[torch.Generator], device,
                      dtype=torch.float32) -> torch.Tensor:
        """The N(0, sigma²) latent ``infer`` draws at ``max_frames`` frames,
        (batch, max_frames // g, n_mel * g), from ``generator``."""
        g = self.n_group_size
        return torch.randn((batch, max_frames // g, self.n_mel_channels * g),
                           generator=generator, device=device,
                           dtype=dtype) * sigma

    def infer(self, spk_vecs, txt_enc, sigma, dur=None, f0=None,
              energy_avg=None, lens: Optional[SeqLens] = None,
              accent_vecs=None, max_frames: Optional[int] = None,
              residual: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Sampling direction z -> mel.

        txt_enc: (B, T_text, C); dur: (B, T_text) frames per token.
        ``residual`` (B, T//g, n_mel*g) overrides the N(0, sigma²) draw,
        which otherwise comes from ``generator``. Returns {'mel', 'lens'}
        with mel (B, T, n_mel), zero past each length."""
        g = self.n_group_size
        if lens is None:
            if dur is None or max_frames is None:
                raise ValueError("infer needs lens, or dur and max_frames")
            txt_expanded, out_lens = regulate_length(txt_enc, dur, max_frames)
            lens = SeqLens.create(out_lens, max_frames)
        else:
            txt_expanded, _ = regulate_length(txt_enc, dur, lens.max_len)

        ctx = self.preprocess_context(txt_expanded, spk_vecs, lens, f0,
                                      energy_avg, accent_vecs)
        if residual is None:
            residual = self.draw_residual(txt_enc.shape[0], lens.max_len,
                                          sigma, generator, txt_enc.device,
                                          txt_enc.dtype)

        exits = self.exit_steps
        z = residual[..., len(exits) * self.n_early_size:]
        mask = lens.downsample(g).mask
        for i in range(self.n_flows - 1, -1, -1):
            z = self.flows[i].inverse(z, ctx, mask)
            if exits and i == exits[-1]:
                exits = exits[:-1]
                lo = len(exits) * self.n_early_size
                z = torch.cat([residual[..., lo:lo + self.n_early_size], z],
                              dim=-1)

        mel = unsqueeze_time(z, g)
        mel = mel * lens.fmask(mel.dtype)[..., None]
        return {"mel": mel, "lens": lens}
