"""Sequence-length masking utilities.

Counterpart of ``radmmm_tpu/utils/masking.py``: masks are built against a
padded length chosen by the caller (the serving bucket), not
``lengths.max()``.
"""
from __future__ import annotations

import dataclasses

import torch


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean mask (B, max_len): True at valid positions."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] < lengths[:, None]


@dataclasses.dataclass(frozen=True)
class SeqLens:
    """Lengths + cached boolean mask for a padded batch (B, T)."""

    lengths: torch.Tensor  # (B,) int32
    mask: torch.Tensor     # (B, T) bool

    @classmethod
    def create(cls, lengths: torch.Tensor, max_len: int) -> "SeqLens":
        lengths = lengths.to(torch.int32)
        return cls(lengths=lengths, mask=mask_from_lengths(lengths, max_len))

    @property
    def max_len(self) -> int:
        return self.mask.shape[-1]

    def downsample(self, factor: int) -> "SeqLens":
        """Lengths // factor with the mask at T // factor frames (the flow's
        time squeeze by n_group_size)."""
        new_len = self.mask.shape[-1] // factor
        new_lengths = torch.div(self.lengths, factor, rounding_mode="floor")
        return SeqLens(lengths=new_lengths,
                       mask=mask_from_lengths(new_lengths, new_len))

    def fmask(self, dtype=torch.float32) -> torch.Tensor:
        return self.mask.to(dtype)
