"""Length regulation: expand text frames by integer durations, batched.

Counterpart of ``radmmm_tpu/ops/length_regulator.py``: output frame t takes
text index searchsorted(cumsum(dur), t, right=True), one gather for the
whole batch.
"""
from __future__ import annotations

import torch


def regulate_length(x: torch.Tensor, durations: torch.Tensor,
                    max_out_len: int):
    """x: (B, T_text, C); durations: (B, T_text) ints >= 0.

    Returns (out (B, max_out_len, C), out_lens (B,)), zero past
    sum(durations)."""
    ends = torch.cumsum(durations, dim=1)                 # (B, T_text)
    out_lens = ends[:, -1]
    t = torch.arange(max_out_len, device=x.device, dtype=ends.dtype)
    idx = torch.searchsorted(ends.contiguous(),
                             t.expand(x.shape[0], -1).contiguous(),
                             right=True)
    idx = idx.clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = t[None, :] < out_lens[:, None]
    return out * valid[:, :, None].to(x.dtype), out_lens
