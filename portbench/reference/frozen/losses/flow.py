"""Flow NLL, the attention losses and the attribute losses.

Counterpart of ``radmmm_tpu/losses/flow.py`` (``compute_flow_loss``,
``attention_binarization_loss``, ``attention_loss``, ``RADMMMLoss``,
``masked_regression_loss``, ``masked_bce_loss``, ``AttributeRegressionLoss``
and ``AttributeBCELoss``; the alternative decoders' losses are not
copied). A loss dict maps a name to (value, weight), as in the JAX
package; the decoder's loss adds the attention terms (the CTC loss
through the plain twins of K1 and K2). One process, one card: every
normaliser is this batch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.frozen.losses.ctc import attention_ctc_loss
from portbench.reference.frozen.utils.masking import SeqLens


def compute_flow_loss(z, log_det_W_list, log_s_list, n_elements, n_dims,
                      mask, sigma=1.0, n_local=None):
    """Masked flow NLL. z (B, Tg, C); mask (B, Tg) float; n_elements the
    number of valid frames (``n_local`` the same where given). Returns
    (loss, prior NLL), both per element."""
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
    return -(hard * logp).sum() / hard.sum().clamp_min(1.0)


def attention_loss(attn, attn_soft, attn_logprob, binarization_on: bool,
                   in_lens: SeqLens, out_lens: SeqLens,
                   ctc_blank_logprob=-1.0, binarization_loss_weight=1.0,
                   ctc_loss_weight=0.1):
    """{'loss_ctc', 'binarization_loss'}; the latter is 0 until
    ``binarization_on``."""
    ctc = attention_ctc_loss(attn_logprob, in_lens.lengths, out_lens.lengths,
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
                model_output["log_s_list"], n_local, n_dims,
                glens.fmask(), self.sigma, n_local=n_local)
            loss_dict["loss_mel"] = (loss_mel, 1.0)
            loss_dict["loss_prior_mel"] = (loss_prior, 0.0)
        loss_dict.update(attention_loss(
            model_output["attn"], model_output["attn_soft"],
            model_output["attn_logprob"], binarization_on, in_lens, out_lens,
            self.ctc_blank_logprob, self.binarization_loss_weight,
            self.ctc_loss_weight))
        return loss_dict


def masked_regression_loss(prediction, target, mask):
    """Masked MSE, the mean over valid entries (mask broadcastable)."""
    m = mask.to(prediction.dtype)
    se = (prediction - target) ** 2 * m
    return se.sum() / m.sum().clamp_min(1.0)


def masked_bce_loss(prediction_logits, target, mask):
    """Masked binary cross-entropy on logits."""
    m = mask.to(prediction_logits.dtype)
    x, y = prediction_logits, target
    per = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return (per * m).sum() / m.sum().clamp_min(1.0)


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
