"""Invertible 1x1 channel mixes of the flow.

Counterpart of ``radmmm_tpu/ops/invertible.py`` (``InvertibleLU``,
``WhiteningConv``, ``whitening_stats``, ``whitening_params_from_stats``;
WaveGlow's ``InvertibleConv`` is not copied).
Channels-last: y[t] = W @ x[t] is ``x @ W.T``. The forward (training)
direction returns y and log|det W| = sum log|upper_diag|; the inverse
direction (sampling) applies W^-1.

The inverse W^-1 depends only on the weights, so ``cache_inverse()``
computes it once after the weights are loaded (the serving loader calls it
through ``TTSModel.cache_inverses``) and stores it in a non-persistent
buffer that follows the module across devices. ``train()`` and
``drop_inverse()`` drop the cache, since the weights may change from then
on; without a cache the inverse is computed on each call. A later
``cache_inverse()`` on the same device writes into the storage of the
first, so a CUDA graph that reads the cache (the trainer's sample graphs)
replays with the inverse of the weights at the last call, never with a
freed or stale one. It is computed in
float64: the whitening W is ill-conditioned (cond ~ 200 at 160 channels),
and an inverse taken while TF32 matmuls are enabled would carry their
error into every mel. The whitening init takes its inverse and Cholesky in
float64 for the same reason. The LU factors of the initial W come from
numpy/scipy QR + LU on the host, as in the JAX package, so a module
initialised from a seed starts from a consistent orthonormal W.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.linalg
import torch
from torch import nn



@functools.lru_cache(maxsize=None)
def _lu_factors_host(seed: int, c: int):
    """Random orthonormal (det=+1) W and its P, L, U factors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, c)).astype(np.float64)
    q, _ = np.linalg.qr(w)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    p, l, u = scipy.linalg.lu(q)
    return (p.astype(np.float32), np.tril(l, -1).astype(np.float32),
            np.triu(u, 1).astype(np.float32),
            np.diagonal(u).astype(np.float32).copy())


class _Invertible1x1(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w_inv", None, persistent=False)
        # the cache's storage, kept when the cache is dropped
        self._inv_store = None

    def weight(self) -> torch.Tensor:
        raise NotImplementedError

    def inverse_weight(self) -> torch.Tensor:
        w = self.weight()
        return torch.linalg.inv(w.double()).to(w.dtype)

    def cache_inverse(self) -> None:
        with torch.no_grad():
            w_inv = self.inverse_weight()
            store = self._inv_store
            if store is None or store.shape != w_inv.shape \
                    or store.device != w_inv.device \
                    or store.dtype != w_inv.dtype:
                self._inv_store = store = w_inv
            else:
                store.copy_(w_inv)
            self.w_inv = store

    def drop_inverse(self) -> None:
        self.w_inv = None

    def train(self, mode: bool = True):
        if mode:
            self.drop_inverse()
        return super().train(mode)

    def log_det(self) -> torch.Tensor:
        return torch.log(torch.abs(self.upper_diag)).sum()

    def _inverse_mix(self, z: torch.Tensor) -> torch.Tensor:
        w_inv = (self.w_inv if self.w_inv is not None
                 else self.inverse_weight())
        return torch.matmul(z, w_inv.t())


class InvertibleLU(_Invertible1x1):
    """W = P·L·U; P a fixed buffer, L unit lower and U upper triangular."""

    def __init__(self, channels: int, init_seed: int = 0):
        super().__init__()
        p, lower, upper, upper_diag = _lu_factors_host(init_seed, channels)
        self.register_buffer("p", torch.from_numpy(p.copy()))
        self.lower = nn.Parameter(torch.from_numpy(lower.copy()))
        self.upper = nn.Parameter(torch.from_numpy(upper.copy()))
        self.upper_diag = nn.Parameter(torch.from_numpy(upper_diag.copy()))

    def weight(self) -> torch.Tensor:
        eye = torch.eye(self.lower.shape[0], device=self.lower.device)
        lower = torch.tril(self.lower, -1) + eye
        upper = torch.triu(self.upper, 1) + torch.diag(self.upper_diag)
        return self.p @ (lower @ upper)

    def forward(self, z: torch.Tensor):
        """(z @ W.T, log|det W|)."""
        return torch.matmul(z, self.weight().t()), self.log_det()

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return self._inverse_mix(z)


class WhiteningConv(_Invertible1x1):
    """Data-initialised whitening 1x1: y = U (x - mean); the inverse is
    x = U^-1 y + mean."""

    def __init__(self, channels: int, init_seed: int = 0):
        super().__init__()
        _, _, upper, upper_diag = _lu_factors_host(init_seed + 7919, channels)
        self.upper = nn.Parameter(torch.from_numpy(upper.copy()))
        self.upper_diag = nn.Parameter(torch.from_numpy(upper_diag.copy()))
        self.register_buffer("input_mean", torch.zeros(channels))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    def weight(self) -> torch.Tensor:
        return torch.triu(self.upper, 1) + torch.diag(self.upper_diag)

    def forward(self, z: torch.Tensor):
        """((z - mean) @ W.T, log|det W|)."""
        return (torch.matmul(z - self.input_mean, self.weight().t()),
                self.log_det())

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return self._inverse_mix(z) + self.input_mean


def whitening_stats(data: torch.Tensor, mask: torch.Tensor):
    """Masked mean (C,) and covariance (C, C) over the valid frames of
    data (B, T, C), mask (B, T); the covariance from the centred data
    (two passes: E[x^2] - E[x]^2 cancels in f32 at the mel floor)."""
    m = mask.to(data.dtype)
    n = m.sum()
    mean = torch.einsum("btc,bt->c", data, m) / n
    centered = (data - mean) * m[..., None]
    covar = torch.einsum("btc,btd->cd", centered, centered) / n
    return mean, covar


def whitening_params_from_stats(mean: torch.Tensor, covar: torch.Tensor,
                                ridge: float = 1e-5) -> dict:
    """The upper Cholesky factor U of covar^-1 (so cov(U (x - mean)) = I),
    as {upper, upper_diag, input_mean}. A trace-scaled ridge keeps the
    inverse finite when the batch has fewer valid frames than channels.
    Inverse and Cholesky run in float64."""
    c = covar.shape[0]
    cov = covar.double()
    cov = cov + (ridge * torch.trace(cov) / c) * torch.eye(
        c, dtype=cov.dtype, device=cov.device)
    w = torch.linalg.cholesky(torch.linalg.inv(cov)).t().to(covar.dtype)
    return {"upper": torch.triu(w, 1), "upper_diag": torch.diagonal(w).clone(),
            "input_mean": mean}
