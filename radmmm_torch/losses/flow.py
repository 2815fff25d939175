"""Flow NLL, the attention losses and the attribute losses.

Counterpart of ``radmmm_tpu/losses/flow.py`` (``compute_flow_loss``,
``attention_binarization_loss``, ``attention_loss``, ``RADMMMLoss``,
the alternative decoders' ``RADTTSDeterministicLoss``,
``RADTTSDiffusionLoss`` and ``RADTTSE2EGANLoss``,
``masked_regression_loss``, ``masked_bce_loss``, ``AttributeRegressionLoss``
and ``AttributeBCELoss``). A loss dict maps a name to (value, weight), as
in the JAX package; every decoder's loss adds the attention terms (the CTC
loss through K1 and K2 on the card).

Under a data mesh (``parallel.mesh``) each value is this rank's share of
the term over the global batch: its sums over its own items divided by
the global normaliser (frames, items or mask entries summed over the data
group), so the shares add up over the ranks to the term the JAX step
computes on the concatenated batch, and so do their gradients. In one
process the share is the term.
"""
from __future__ import annotations

from typing import Optional

import torch

from radmmm_torch.losses.ctc import attention_ctc_loss
from radmmm_torch.losses.stft_loss import MultiResolutionSTFTLoss
from radmmm_torch.parallel import mesh
from radmmm_torch.utils.masking import SeqLens
from radmmm_torch.utils.profiling import train_span


def compute_flow_loss(z, log_det_W_list, log_s_list, n_elements, n_dims,
                      mask, sigma=1.0, n_local=None):
    """Masked flow NLL. z (B, Tg, C); mask (B, Tg) float; n_elements the
    number of valid frames of the global batch, ``n_local`` this rank's
    (by default ``n_elements``). Returns (loss, prior NLL), both per
    element: this rank's shares."""
    m = mask[..., None]
    log_s_total = sum((ls * m).sum() for ls in log_s_list)
    log_det_W_total = sum(log_det_W_list) if log_det_W_list else 0.0
    log_det_W_total = log_det_W_total * (n_elements if n_local is None
                                         else n_local)
    z = z * m
    prior_nll = (z * z).sum() / (2 * sigma * sigma)
    loss = prior_nll - log_s_total - log_det_W_total
    denom = n_elements * n_dims
    return loss / denom, prior_nll / denom


def attention_binarization_loss(hard_attention, soft_attention):
    """Mean -log(soft) at the hard alignment's ones (the hard attention is
    a constant)."""
    hard = hard_attention.detach()
    logp = torch.log(soft_attention.clamp(1e-12, 1.0))
    return -(hard * logp).sum() / mesh.data_sum(hard.sum()).clamp_min(1.0)


def attention_loss(attn, attn_soft, attn_logprob, binarization_on: bool,
                   in_lens: SeqLens, out_lens: SeqLens,
                   ctc_blank_logprob=-1.0, binarization_loss_weight=1.0,
                   ctc_loss_weight=0.1):
    """{'loss_ctc', 'binarization_loss'}; the latter is 0 until
    ``binarization_on``."""
    with train_span("train.align", attn_logprob.device):
        ctc = attention_ctc_loss(attn_logprob, in_lens.lengths,
                                 out_lens.lengths,
                                 blank_logprob=ctc_blank_logprob)
    b = (attention_binarization_loss(attn, attn_soft) if binarization_on
         else attn_soft.new_zeros(()))
    return {"loss_ctc": (ctc, ctc_loss_weight),
            "binarization_loss": (b, binarization_loss_weight)}


class RADMMMLoss:
    """Flow NLL + attention losses."""

    def __init__(self, sigma=1.0, n_group_size=1, ctc_blank_logprob=-1.0,
                 binarization_loss_weight=1.0, ctc_loss_weight=0.1):
        self.sigma = sigma
        self.n_group_size = n_group_size
        self.ctc_blank_logprob = ctc_blank_logprob
        self.binarization_loss_weight = binarization_loss_weight
        self.ctc_loss_weight = ctc_loss_weight

    def __call__(self, model_output, in_lens: SeqLens, out_lens: SeqLens,
                 binarization_on: bool):
        loss_dict = {}
        if model_output.get("z_mel") is not None:
            glens = out_lens.downsample(self.n_group_size)
            n_local = glens.lengths.sum().to(torch.float32)
            n_dims = model_output["z_mel"].shape[-1]
            loss_mel, loss_prior = compute_flow_loss(
                model_output["z_mel"], model_output["log_det_W_list"],
                model_output["log_s_list"], mesh.data_sum(n_local), n_dims,
                glens.fmask(), self.sigma, n_local=n_local)
            loss_dict["loss_mel"] = (loss_mel, 1.0)
            loss_dict["loss_prior_mel"] = (loss_prior, 0.0)
        loss_dict.update(attention_loss(
            model_output["attn"], model_output["attn_soft"],
            model_output["attn_logprob"], binarization_on, in_lens, out_lens,
            self.ctc_blank_logprob, self.binarization_loss_weight,
            self.ctc_loss_weight))
        return loss_dict


class _AttentionTerms:
    """The attention-loss settings shared by the alternative decoders'
    losses (``kl_loss_start_iter`` is taken and unused: the caller's
    ``binarization_on`` decides)."""

    def __init__(self, ctc_blank_logprob=-1.0, kl_loss_start_iter=5000,
                 binarization_loss_weight=1.0, ctc_loss_weight=0.1):
        self.ctc_blank_logprob = ctc_blank_logprob
        self.binarization_loss_weight = binarization_loss_weight
        self.ctc_loss_weight = ctc_loss_weight

    def _attention(self, model_output, in_lens, out_lens, binarization_on):
        return attention_loss(
            model_output["attn"], model_output["attn_soft"],
            model_output["attn_logprob"], binarization_on, in_lens, out_lens,
            self.ctc_blank_logprob, self.binarization_loss_weight,
            self.ctc_loss_weight)


class RADTTSDeterministicLoss(_AttentionTerms):
    """Masked L1 mel loss + the attention losses."""

    def __call__(self, model_output, in_lens: SeqLens, out_lens: SeqLens,
                 binarization_on: bool):
        loss_dict = {}
        if model_output.get("mel_hat") is not None:
            m = out_lens.fmask()[..., None]
            mel, mel_hat = model_output["mel"], model_output["mel_hat"]
            loss = (torch.abs(mel - mel_hat) * m).sum() / (
                mel.shape[-1] * mesh.data_sum(m.sum()).clamp_min(1.0))
            loss_dict["mel_mae_loss"] = (loss, 1.0)
        loss_dict.update(self._attention(model_output, in_lens, out_lens,
                                         binarization_on))
        return loss_dict


class RADTTSDiffusionLoss(_AttentionTerms):
    """Masked noise-prediction MSE + the attention losses."""

    def __call__(self, model_output, in_lens: SeqLens, out_lens: SeqLens,
                 binarization_on: bool):
        loss_dict = {}
        if model_output.get("noise_hat") is not None:
            m = out_lens.fmask()[..., None]
            noise, noise_hat = model_output["noise"], model_output["noise_hat"]
            loss = (((noise - noise_hat) ** 2) * m).sum() / (
                noise.shape[-1] * mesh.data_sum(m.sum()).clamp_min(1.0))
            loss_dict["noise_mse_loss"] = (loss, 1.0)
        loss_dict.update(self._attention(model_output, in_lens, out_lens,
                                         binarization_on))
        return loss_dict


class RADTTSE2EGANLoss(_AttentionTerms):
    """Multi-resolution STFT reconstruction of the waveform (five
    resolutions, A-weighted log magnitudes by default) + the attention
    losses. Under a data mesh the length ratios are relative to the global
    batch's longest item (a max over the data group) and the losses'
    normalisers are global (``stft_loss``), so each rank's loss is its
    share of the global batch's, as JAX computes it on the global batch."""

    def __init__(self, ctc_blank_logprob=-1.0, kl_loss_start_iter=5000,
                 binarization_loss_weight=1.0, ctc_loss_weight=0.1,
                 stft_loss_sc_weight=1.0, stft_loss_mag_weight=1.0,
                 fft_lengths=(1024, 2048, 512, 64, 8192),
                 hop_lengths=(120, 240, 50, 10, 2000),
                 win_lengths=(600, 1200, 240, 50, 8000),
                 sampling_rate=22050, a_weighting=True):
        super().__init__(ctc_blank_logprob, kl_loss_start_iter,
                         binarization_loss_weight, ctc_loss_weight)
        self.stft_loss_sc_weight = stft_loss_sc_weight
        self.stft_loss_mag_weight = stft_loss_mag_weight
        self.mrstft = MultiResolutionSTFTLoss(
            fft_lengths, hop_lengths, win_lengths, sampling_rate, a_weighting)

    def __call__(self, model_output, audio, audio_lens, in_lens: SeqLens,
                 out_lens: SeqLens, binarization_on: bool):
        audio_hat = model_output["audio_hat"]
        T = min(audio.shape[-1], audio_hat.shape[-1])
        audio, audio_hat = audio[..., :T], audio_hat[..., :T]
        len_ratios = audio_lens / mesh.data_max(audio_lens.max()).clamp_min(1)
        sc, mag = self.mrstft(audio, audio_hat, len_ratios)
        loss_dict = {"stft_loss_sc": (sc, self.stft_loss_sc_weight),
                     "stft_loss_mag": (mag, self.stft_loss_mag_weight)}
        loss_dict.update(self._attention(model_output, in_lens, out_lens,
                                         binarization_on))
        return loss_dict


def masked_regression_loss(prediction, target, mask):
    """Masked MSE, the mean over valid entries (mask broadcastable)."""
    m = mask.to(prediction.dtype)
    se = (prediction - target) ** 2 * m
    return se.sum() / mesh.data_sum(m.sum()).clamp_min(1.0)


def masked_bce_loss(prediction_logits, target, mask):
    """Masked binary cross-entropy on logits."""
    m = mask.to(prediction_logits.dtype)
    x, y = prediction_logits, target
    per = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return (per * m).sum() / mesh.data_sum(m.sum()).clamp_min(1.0)


class AttributeRegressionLoss:
    def __init__(self, prefix: Optional[str] = None, weight=1.0):
        self.prefix = prefix or ""
        self.weight = weight

    def __call__(self, model_output, out_lens: Optional[SeqLens],
                 mask=None):
        if mask is None:
            mask = out_lens.mask[..., None]
        loss = masked_regression_loss(model_output["x_hat"],
                                      model_output["x"], mask)
        return {self.prefix + "loss": (loss, self.weight)}


class AttributeBCELoss:
    def __init__(self, prefix: Optional[str] = None, weight=1.0):
        self.prefix = prefix or ""
        self.weight = weight

    def __call__(self, model_output, out_lens: Optional[SeqLens],
                 mask=None):
        if mask is None:
            mask = out_lens.mask[..., None]
        loss = masked_bce_loss(model_output["x_hat"], model_output["x"],
                               mask)
        return {self.prefix + "loss": (loss, self.weight)}
