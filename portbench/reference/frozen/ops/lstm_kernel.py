"""The masked LSTM recurrence in plain PyTorch: a frozen copy of the
port's twins of its recurrence kernels (``ops/lstm_kernel.py``), on any
device, differentiable in ``x_proj`` and ``wh``. For every lane ``l`` and t
in its walking order:

    gates = x_proj[l, t] + h @ wh[l]        ; i, f, g, o = split(gates)
    c' = f*c + i*g ; h' = o*tanh(c')
    (h, c) <- (h', c') where mask[t] > 0, else kept ; out[l, t] = h' * mask[t]
"""
from __future__ import annotations

from typing import Sequence

import torch

def _walk(T: int, reverse: Sequence[bool], device):
    """(lanes, rev flags, (T, L) time index of each lane's step s)."""
    L = len(reverse)
    lanes = torch.arange(L, device=device)
    rev = torch.as_tensor([bool(r) for r in reverse], device=device)
    s = torch.arange(T, device=device)[:, None]
    return lanes, rev, torch.where(rev[None, :], T - 1 - s, s)


def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              wh: torch.Tensor, reverse: Sequence[bool],
                              save: bool = False):
    """Plain PyTorch twin of the forward kernel: a Python loop over time
    of ``torch.bmm`` and elementwise gates.

    x_proj (L, T, B, 4H); mask (T, B) or (L, T, B); wh (L, H, 4H);
    reverse: L flags. Returns out (L, T, B, H), zero at masked frames;
    with ``save`` also the gate activations (L, T, B, 4H) and the carried
    c and h after every step (L, T, B, H) each, as the backward needs."""
    L, T, B, G = x_proj.shape
    H = G // 4
    m = mask.expand(L, T, B) if mask.dim() == 2 else mask
    lanes, _, order = _walk(T, reverse, x_proj.device)
    h = x_proj.new_zeros((L, B, H))
    c = x_proj.new_zeros((L, B, H))
    out = x_proj.new_empty((L, T, B, H))
    if save:
        act, cs, hs = (x_proj.new_empty((L, T, B, G)),
                       x_proj.new_empty((L, T, B, H)),
                       x_proj.new_empty((L, T, B, H)))
    for s in range(T):
        t = order[s]
        gates = x_proj[lanes, t] + torch.bmm(h, wh)
        i, f, g, o = gates.split(H, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        mt = m[lanes, t][..., None]
        h = torch.where(mt > 0, h_new, h)
        c = torch.where(mt > 0, c_new, c)
        out[lanes, t] = h_new * mt
        if save:
            act[lanes, t] = torch.cat([i, f, g, o], dim=-1)
            cs[lanes, t] = c
            hs[lanes, t] = h
    return (out, act, cs, hs) if save else out


def lstm_recurrence_backward_reference(dout: torch.Tensor, act: torch.Tensor,
                                       cs: torch.Tensor, mask: torch.Tensor,
                                       wh: torch.Tensor,
                                       reverse: Sequence[bool]
                                       ) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: reverse-time BPTT over
    the saved gate activations ``act`` and carried cell states ``cs``.
    Returns d x_proj (L, T, B, 4H): the gate pre-activations' gradient,
    zero at masked frames, where dh and dc pass through unchanged."""
    L, T, B, H = dout.shape
    m = mask.expand(L, T, B) if mask.dim() == 2 else mask
    lanes, _, order = _walk(T, reverse, dout.device)
    wh_t = wh.transpose(1, 2)
    dxp = dout.new_zeros((L, T, B, 4 * H))
    dh_pass = dout.new_zeros((L, B, H))
    dc_pass = dout.new_zeros((L, B, H))
    rec = dout.new_zeros((L, B, H))
    for s in range(T - 1, -1, -1):
        t = order[s]
        c_prev = (cs[lanes, order[s - 1]] if s > 0
                  else torch.zeros_like(dh_pass))
        i, f, g, o = act[lanes, t].split(H, dim=-1)
        tc = torch.tanh(cs[lanes, t])
        mt = m[lanes, t][..., None]
        keep = mt > 0
        dh = dh_pass + rec
        dhn = dh + dout[lanes, t] * mt
        dcn = dc_pass + dhn * o * (1 - tc * tc)
        dgates = torch.cat([dcn * g * i * (1 - i),
                            dcn * c_prev * f * (1 - f),
                            dcn * i * (1 - g * g),
                            dhn * tc * o * (1 - o)], dim=-1)
        dgates = torch.where(keep, dgates, torch.zeros_like(dgates))
        dh_pass = torch.where(keep, torch.zeros_like(dh), dh)
        dc_pass = torch.where(keep, dcn * f, dc_pass)
        rec = torch.bmm(dgates, wh_t)
        dxp[lanes, t] = dgates
    return dxp


def recurrent_weight_grad(hs: torch.Tensor, dxp: torch.Tensor,
                          reverse: Sequence[bool]) -> torch.Tensor:
    """dWh (L, H, 4H) = sum over steps of h_prev^T dgates: one batched
    product over the carried h entering each step and d x_proj."""
    L, T, B, G = dxp.shape
    h_prev = _h_before(hs, reverse).view(L, T * B, G // 4).transpose(1, 2)
    dg = dxp.view(L, T * B, G)
    return torch.bmm(h_prev, dg)


def _h_before(hs: torch.Tensor, reverse: Sequence[bool]) -> torch.Tensor:
    """The carried h entering each step (zero at each lane's first)."""
    prev = torch.zeros_like(hs)
    for l, r in enumerate(reverse):
        if r:
            prev[l, :-1] = hs[l, 1:]
        else:
            prev[l, 1:] = hs[l, :-1]
    return prev


def _check(x_proj, mask, wh, reverse):
    L, T, B, G = x_proj.shape
    H = G // 4
    if (G != 4 * H or wh.shape != (L, H, G) or len(reverse) != L
            or mask.shape not in ((T, B), (L, T, B))):
        raise ValueError(
            f"lstm_recurrence: x_proj {tuple(x_proj.shape)}, mask "
            f"{tuple(mask.shape)}, wh {tuple(wh.shape)}, {len(reverse)} "
            "reverse flags do not describe L lanes of (T, B, 4H)")
    for name, t in (("x_proj", x_proj), ("mask", mask), ("wh", wh)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_recurrence: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"lstm_recurrence: {name} is on {t.device}, "
                             f"x_proj on {x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} must be contiguous")


class _LSTMRecurrence(torch.autograd.Function):
    """The recurrence with its backward, both plain twins."""

    @staticmethod
    def forward(ctx, x_proj, mask, wh, reverse):
        out, act, cs, hs = lstm_recurrence_reference(
            x_proj, mask, wh, reverse, save=True)
        ctx.reverse = tuple(reverse)
        ctx.save_for_backward(mask, wh, act, cs, hs)
        return out

    @staticmethod
    def backward(ctx, dout):
        mask, wh, act, cs, hs = ctx.saved_tensors
        dout = dout.contiguous()
        dxp = lstm_recurrence_backward_reference(
            dout, act, cs, mask, wh, ctx.reverse)
        dwh = recurrent_weight_grad(hs, dxp, ctx.reverse)
        return dxp, None, dwh, None


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    wh: torch.Tensor, reverse: Sequence[bool]) -> torch.Tensor:
    """The masked multi-lane LSTM recurrence (see the module docstring),
    on any device."""
    _check(x_proj, mask, wh, reverse)
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or wh.requires_grad):
        return _LSTMRecurrence.apply(x_proj, mask, wh, list(reverse))
    return lstm_recurrence_reference(x_proj, mask, wh, reverse)


