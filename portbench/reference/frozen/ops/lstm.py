"""Masked (bi)directional LSTMs over padded sequences.

Counterpart of ``radmmm_tpu/ops/lstm.py``. Hidden state is carried through
masked (padding) steps unchanged and outputs are zero there, which is
packed-sequence semantics for prefix masks. The input projection
``x @ Wi + b`` is one ``ops.conv.matmul`` over all frames; the recurrence
itself goes through ``lstm_kernel.lstm_recurrence`` (the plain twin of
the port's kernel), one call per (Bi)LSTM, differentiable in every
weight.

Weights keep the JAX layout: Wi (C_in, 4H), Wh (H, 4H), b_ih and b_hh
(4H,), gate order (i, f, g, o).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from portbench.reference.frozen.ops.conv import matmul
from portbench.reference.frozen.ops.lstm_kernel import lstm_recurrence


def multi_bilstm_scan(xs: torch.Tensor, mask: torch.Tensor, wi: torch.Tensor,
                      wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """P independent bidirectional masked LSTMs in ONE recurrence launch of
    2P lanes (forward lanes walk up, backward lanes walk down).

    xs: (P, B, T, C); mask: (B, T); wi: (P, C, 8H) [fwd | bwd];
    wh: (P, 2, H, 4H); bias: (P, 2, 4H) (b_ih + b_hh).
    Returns (P, B, T, 2H), [fwd | bwd], zero at padding.
    """
    P, B, T, _ = xs.shape
    H = wh.shape[-2]
    xp = matmul(xs.reshape(P, B * T, -1), wi)                 # (P,BT,8H)
    xp = xp.view(P, B, T, 2, 4 * H) + bias[:, None, None]
    x_l = xp.permute(0, 3, 2, 1, 4).reshape(2 * P, T, B, 4 * H)
    x_l = x_l.contiguous()        # a reshape may keep a strided view
    m = mask.to(xs.dtype).t().contiguous()                    # (T, B)
    ys = lstm_recurrence(x_l, m, wh.reshape(2 * P, H, 4 * H).contiguous(),
                         [False, True] * P)                   # (2P,T,B,H)
    return ys.view(P, 2, T, B, H).permute(0, 3, 2, 1, 4).reshape(
        P, B, T, 2 * H)


class SpectralNormedParam(nn.Module):
    """Spectral norm of a recurrent weight, as the JAX module computes it:
    one power iteration from the stored ``u`` on every call, under
    ``no_grad`` (sigma's gradient flows through W only); with ``update``
    (training) the new ``u`` is written back. (``torch.nn.utils.
    spectral_norm`` in eval mode runs no iteration, so it would give
    another sigma.)"""

    def __init__(self, rows: int):
        super().__init__()
        self.register_buffer("u", torch.randn(rows))

    def forward(self, w: torch.Tensor, update: bool = False) -> torch.Tensor:
        w2d = w.t()                                           # (4H, H)
        with torch.no_grad():
            u = self.u / torch.linalg.vector_norm(self.u).clamp_min(1e-12)
            v = w2d.t() @ u
            v = v / torch.linalg.vector_norm(v).clamp_min(1e-12)
            u_new = w2d @ v
            u_new = u_new / torch.linalg.vector_norm(u_new).clamp_min(1e-12)
            if update:
                self.u.copy_(u_new)
        sigma = u_new @ (w2d @ v)
        return w / sigma


class MaskedLSTM(nn.Module):
    """(Bi)LSTM over padded sequences; ``hidden`` is per direction."""

    def __init__(self, in_channels: int, hidden: int,
                 bidirectional: bool = True, spectral_norm: bool = False):
        super().__init__()
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.spectral_norm = spectral_norm
        self.dirs = ["fwd", "bwd"] if bidirectional else ["fwd"]
        bound = 1.0 / math.sqrt(hidden)

        def uniform(*shape):
            return nn.Parameter(torch.empty(*shape).uniform_(-bound, bound))

        for d in self.dirs:
            setattr(self, f"wi_{d}", uniform(in_channels, 4 * hidden))
            setattr(self, f"wh_{d}", uniform(hidden, 4 * hidden))
            setattr(self, f"b_ih_{d}", uniform(4 * hidden))
            setattr(self, f"b_hh_{d}", uniform(4 * hidden))
            if spectral_norm:
                setattr(self, f"sn_{d}", SpectralNormedParam(4 * hidden))

    def _weights(self, d: str, update_sn: bool = False):
        wh = getattr(self, f"wh_{d}")
        if self.spectral_norm:
            wh = getattr(self, f"sn_{d}")(wh, update_sn)
        return (getattr(self, f"wi_{d}"), wh,
                getattr(self, f"b_ih_{d}") + getattr(self, f"b_hh_{d}"))

    def weights(self, update_sn: bool = False) -> dict:
        """Stacked [fwd | bwd] weights for ``multi_bilstm_scan`` (gang
        mode): wi (C, 8H), wh (2, H, 4H), bias (2, 4H). ``update_sn``
        writes back the spectral norms' new ``u`` (training)."""
        if not self.bidirectional:
            raise ValueError("gang mode is bidirectional-only")
        (wi_f, wh_f, b_f), (wi_b, wh_b, b_b) = (
            self._weights("fwd", update_sn), self._weights("bwd", update_sn))
        return {"wi": torch.cat([wi_f, wi_b], dim=1),
                "wh": torch.stack([wh_f, wh_b]),
                "bias": torch.stack([b_f, b_b])}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                update_sn: bool = False) -> torch.Tensor:
        """x: (B, T, C); mask: (B, T). Returns (B, T, H * directions)."""
        m = x.new_ones(x.shape[:2]) if mask is None else mask.to(x.dtype)
        if self.bidirectional:
            w = self.weights(update_sn)
            return multi_bilstm_scan(x[None], m, w["wi"][None],
                                     w["wh"][None], w["bias"][None])[0]
        wi, wh, b = self._weights("fwd", update_sn)
        xp = (matmul(x, wi) + b).transpose(0, 1)[None].contiguous()
        ys = lstm_recurrence(xp, m.t().contiguous(), wh[None].contiguous(),
                             [False])
        return ys[0].transpose(0, 1)
