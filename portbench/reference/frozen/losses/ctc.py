"""Attention CTC ("ForwardSum") loss with the alpha-beta posterior
gradient.

Counterpart of ``radmmm_tpu/losses/ctc.py``. Per item, the target is the
sequence of text tokens 1..S with a blank column (log-prob
``blank_logprob``) prepended; states s in [0, 2S] (even: blank, odd: token
(s+1)/2). The loss of an item is -log p / S (torch CTCLoss 'mean' for one
item), zero where it is not finite (``zero_infinity``), averaged over the
batch.

``attention_ctc_loss`` is a ``torch.autograd.Function``: its forward runs
the alpha DP (``ctc_kernel.ctc_alpha``, K1) and keeps every row; its
backward runs the beta DP (``ctc_kernel.ctc_beta``, K2), folds the state
posteriors into text columns and applies d loss / d logits =
coef * (posterior - softmax) with torch ops.
"""
from __future__ import annotations

import torch

from portbench.reference.frozen.losses.ctc_kernel import NEG_INF, ctc_alpha, ctc_beta


def _masked_log_softmax(x, valid, dim):
    x = torch.where(valid, x, NEG_INF)
    m = x.amax(dim=dim, keepdim=True)
    e = torch.where(valid, torch.exp(x - m), 0.0)
    lse = torch.log(e.sum(dim=dim, keepdim=True)) + m
    return torch.where(valid, x - lse, NEG_INF)


def _ctc_setup(attn_logprob, text_lens, blank_logprob):
    """Masked log-softmax over [blank] + the valid text columns, and the
    per-state emissions (B, T_mel, 2S+1) gathered from it."""
    B, T_mel, T_text = attn_logprob.shape
    logp = torch.cat([attn_logprob.new_full((B, T_mel, 1), blank_logprob),
                      attn_logprob], dim=-1)
    cols = torch.arange(T_text + 1, device=attn_logprob.device)
    col_valid = cols[None, :] <= text_lens[:, None]           # (B, S+1)
    logp = _masked_log_softmax(logp, col_valid[:, None, :], dim=-1)
    s = torch.arange(2 * T_text + 1, device=attn_logprob.device)
    col_of_state = torch.where(s % 2 == 1, (s + 1) // 2, 0)
    emit_all = logp.gather(
        -1, col_of_state.expand(B, T_mel, -1)).contiguous()
    return logp, emit_all, col_valid


def _ll_from_alpha(alpha, text_lens):
    """log p from the final alpha row: logaddexp of the last blank and the
    last label state."""
    idx = (2 * text_lens).long()
    end_blank = alpha.gather(1, idx[:, None])[:, 0]
    end_label = alpha.gather(1, (idx - 1).clamp_min(0)[:, None])[:, 0]
    m = torch.maximum(end_blank, end_label)
    return m + torch.log(torch.exp(end_blank - m) + torch.exp(end_label - m))


def _loss_from_ll(ll, text_lens, n_items: int):
    per_item = -ll / text_lens.to(ll.dtype).clamp_min(1.0)
    finite = torch.isfinite(per_item) & (per_item < 1e29)    # zero_infinity
    per_item = torch.where(finite, per_item, 0.0)
    return per_item.sum() / n_items, finite


class _AttentionCTC(torch.autograd.Function):

    @staticmethod
    def forward(ctx, attn_logprob, text_lens, mel_lens, blank_logprob):
        logp, emit_all, col_valid = _ctc_setup(attn_logprob, text_lens,
                                               blank_logprob)
        alphas = ctc_alpha(emit_all, text_lens, mel_lens)
        ll = _ll_from_alpha(alphas[-1], text_lens)
        ctx.n_items = attn_logprob.shape[0]
        loss, finite = _loss_from_ll(ll, text_lens, ctx.n_items)
        ctx.save_for_backward(logp, emit_all, alphas, ll, finite, text_lens,
                              mel_lens, col_valid)
        return loss

    @staticmethod
    def backward(ctx, ct):
        (logp, emit_all, alphas, ll, finite, text_lens, mel_lens,
         col_valid) = ctx.saved_tensors
        T_mel = logp.shape[1]
        betas = ctc_beta(emit_all, text_lens, mel_lens)
        # state posteriors folded to columns: odd states are the text
        # columns, the even states sum into the blank
        gammas = torch.exp(alphas + betas - ll[None, :, None])  # (T, B, 2S+1)
        u = torch.cat([gammas[..., 0::2].sum(-1, keepdim=True),
                       gammas[..., 1::2]], dim=-1).transpose(0, 1)
        # the posterior sums to 1 on a valid frame, so the log-softmax
        # jacobian collapses to u - softmax
        coef = -ct * finite.to(logp.dtype) / (
            text_lens.to(logp.dtype).clamp_min(1.0) * ctx.n_items)
        dx = coef[:, None, None] * (u - torch.exp(logp))
        t_in = (torch.arange(T_mel, device=logp.device)[None, :]
                < mel_lens[:, None])
        dx = torch.where(t_in[..., None] & col_valid[:, None, :], dx, 0.0)
        return dx[..., 1:], None, None, None


def attention_ctc_loss(attn_logprob: torch.Tensor, text_lens: torch.Tensor,
                       mel_lens: torch.Tensor,
                       blank_logprob: float = -1.0) -> torch.Tensor:
    """attn_logprob (B, T_mel, T_text) unnormalised log-probs (after the
    prior). Returns the scalar loss, the mean over the batch."""
    return _AttentionCTC.apply(attn_logprob.contiguous(),
                               text_lens.to(torch.int32),
                               mel_lens.to(torch.int32), float(blank_logprob))
