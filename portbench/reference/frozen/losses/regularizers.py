"""Embedding-table regularizers for speaker/accent disentanglement.

Counterpart of ``radmmm_tpu/losses/regularizers.py``: VICReg-style variance
and covariance penalties on an embedding table, speaker/accent
cross-covariance and an MSE invariance loss.
"""
from __future__ import annotations

import torch


class VarianceCovarianceEmbeddingRegLoss:
    """Variance hinge + off-diagonal covariance penalty."""

    def __init__(self, name, loss_variance_weight, loss_covariance_weight,
                 gamma=1.0):
        self.name = name
        self.loss_variance_weight = float(loss_variance_weight)
        self.loss_covariance_weight = float(loss_covariance_weight)
        self.gamma = gamma

    def __call__(self, embs: torch.Tensor):
        n, d = embs.shape
        std = torch.sqrt(embs.var(dim=0, unbiased=True) + 1e-4)
        std_loss = (self.gamma - std).clamp_min(0.0).mean()
        centered = embs - embs.mean(dim=0, keepdim=True)
        cov = centered.t() @ centered / (n - 1)
        off = cov * (1.0 - torch.eye(d, dtype=cov.dtype, device=cov.device))
        cov_loss = (off ** 2).sum() / d
        return {
            f"loss_{self.name}_variance": (std_loss,
                                           self.loss_variance_weight),
            f"loss_{self.name}_covariance": (cov_loss,
                                             self.loss_covariance_weight),
        }


class AttributeMinCrossCovarianceRegLoss:
    """Minimise the batch cross-covariance of two embedding spaces, each
    centred on its table's mean."""

    def __init__(self, attr_name1, attr_name2, loss_cross_covariance_weight,
                 gamma=1.0):
        self.attr_name1 = attr_name1
        self.attr_name2 = attr_name2
        self.weight = float(loss_cross_covariance_weight)

    def __call__(self, batch_attr1, batch_attr2, attr1_table=None,
                 attr2_table=None):
        t1 = attr1_table if attr1_table is not None else batch_attr1
        t2 = attr2_table if attr2_table is not None else batch_attr2
        d1, d2 = t1.shape[1], t2.shape[1]
        n = batch_attr1.shape[0]
        a1 = batch_attr1 - t1.mean(dim=0, keepdim=True)
        a2 = batch_attr2 - t2.mean(dim=0, keepdim=True)
        cross = a1.t() @ a2 / (n - 1)
        loss = (cross ** 2).sum() / (d1 * d2)
        key = f"loss_{self.attr_name1}-{self.attr_name2}_cross_covariance"
        return {key: (loss, self.weight)}
