"""Piecewise-linear and piecewise-quadratic monotone spline transforms.

Counterpart of ``radmmm_tpu/ops/splines.py``: the transforms of the
spline couplings (Müller et al., Neural Importance Sampling) as plain
functions on f32 tensors with static shapes, the bin of each point found
by counting edges, so a point on a bin edge, at 0 or at 1 lands in the
bin the JAX functions pick. x is (N, K); the bin logits are (N, K, bins).
The quadratic inverse takes the same larger root of a·α² + b·α + c as
the JAX function, in the conjugate form -2c / (b + sqrt(b² - 4ac)). The
JAX function's (-b + sqrt(b² - 4ac)) / 2a cancels where a bin's slope
changes little (a near 0, as in a spline coupling at init, whose last
conv is zero): there it loses up to about 1e-3 of the result, which the
conjugate form (b > 0 always) does not, and it needs no separate linear
branch.
"""
from __future__ import annotations

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, i[..., None])[..., 0]


def _shift_right(a: torch.Tensor) -> torch.Tensor:
    """[0, a_0, ..., a_{n-2}] along the last axis."""
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def piecewise_linear_transform(x, q_tilde, outlier_passthru: bool = True):
    """Forward CDF transform through a piecewise-constant pdf -> (y,
    log-determinant summed over K)."""
    n_bins = q_tilde.shape[-1]
    w = 1.0 / n_bins
    q = torch.softmax(q_tilde, dim=-1) / w
    x_safe = x.clamp(0.0, 1.0)
    mx = torch.floor(n_bins * x_safe).clamp(0, n_bins - 1).long()
    slopes = _take(q, mx)
    alpha = x_safe - mx.to(x.dtype) * w
    q_left = _shift_right(torch.cumsum(q, dim=-1) * w)
    out = (alpha * slopes + _take(q_left, mx)).clamp(_EPS, 1.0 - _EPS)
    oob = ((x < 0.0) | (x > 1.0)).to(x.dtype)
    if outlier_passthru:
        out = out * (1 - oob) + x * oob
        slopes = slopes * (1 - oob) + oob
    return out, torch.log(slopes).sum(dim=1)


def piecewise_linear_inverse_transform(y, q_tilde,
                                       outlier_passthru: bool = True):
    """Inverse of ``piecewise_linear_transform`` -> (x, log-determinant);
    x carries no gradient, as in the JAX function."""
    n_bins = q_tilde.shape[-1]
    w = 1.0 / n_bins
    q = torch.softmax(q_tilde, dim=-1) / w
    q_left = _shift_right(torch.cumsum(q, dim=-1) * w)
    y_safe = y.clamp(0.0, 1.0)
    # the bin: the largest index whose left edge is <= y
    edges = ((q_left <= y_safe[..., None]).sum(dim=-1) - 1).clamp(
        0, n_bins - 1)
    ql_b, q_b = _take(q_left, edges), _take(q, edges)
    x = (y_safe - ql_b) / q_b.clamp_min(_EPS) + edges.to(y.dtype) * w
    x = x.clamp(_EPS, 1.0 - _EPS)
    oob = ((y < 0.0) | (y > 1.0)).to(y.dtype)
    if outlier_passthru:
        x = x * (1 - oob) + y * oob
        q_b = q_b * (1 - oob) + oob
    return x.detach(), -torch.log(q_b).sum(dim=1)


def _weighted_softmax(v, w):
    """Vertex heights scaled so the quadratic CDF integrates to 1."""
    v = torch.exp(v - v.max(dim=-1, keepdim=True).values) + 1e-8
    v_sum = ((v[..., :-1] + v[..., 1:]) / 2 * w).sum(dim=-1, keepdim=True)
    return v / v_sum


def piecewise_quadratic_transform(x, w_tilde, v_tilde,
                                  inverse: bool = False):
    """Monotone quadratic spline on [0, 1): K bin widths, K + 1 vertex
    heights. Forward -> (y, elementwise log-determinant); inverse -> (x,
    None)."""
    w = torch.softmax(w_tilde, dim=-1)
    v = _weighted_softmax(v_tilde, w)
    w_cumsum = torch.cumsum(w, dim=-1)
    w_cumsum = torch.cat([w_cumsum[..., :-1],
                          torch.ones_like(w_cumsum[..., -1:])], dim=-1)
    w_cumsum_shift = _shift_right(w_cumsum)
    cdf = torch.cumsum((v[..., 1:] + v[..., :-1]) / 2 * w, dim=-1)
    cdf = torch.cat([cdf[..., :-1], torch.ones_like(cdf[..., -1:])], dim=-1)
    cdf_shift = _shift_right(cdf)

    table = cdf if inverse else w_cumsum
    # searchsorted: the first index whose table entry is >= x
    bin_index = (table < x[..., None]).sum(dim=-1).clamp(0, w.shape[-1] - 1)
    w_b = _take(w, bin_index)
    w_bn1 = _take(w_cumsum_shift, bin_index)
    v_b = _take(v, bin_index)
    v_bp1 = _take(v, bin_index + 1)
    cdf_bn1 = _take(cdf_shift, bin_index)

    if not inverse:
        alpha = (x - w_bn1) / w_b.clamp_min(_EPS)
        c = ((alpha ** 2) / 2 * (v_bp1 - v_b) * w_b
             + alpha * v_b * w_b + cdf_bn1)
        log_j = torch.log((v_b + alpha * (v_bp1 - v_b)).clamp_min(_EPS))
        return c.clamp(_EPS, 1.0 - _EPS), log_j
    a = (v_bp1 - v_b) * w_b / 2
    b = v_b * w_b
    c = cdf_bn1 - x
    disc = (b ** 2 - 4 * a * c).clamp_min(0.0)
    alpha = -2 * c / (b + torch.sqrt(disc)).clamp_min(_EPS)
    inv = alpha * w_b + w_bn1
    return inv.clamp(_EPS, 1.0 - _EPS), None


def unbounded_piecewise_quadratic_transform(x, w_tilde, v_tilde,
                                            upper: float = 1.0,
                                            lower: float = 0.0,
                                            inverse: bool = False):
    """The identity outside [lower, upper), the quadratic spline inside;
    computed everywhere, then selected."""
    rng = upper - lower
    inside = (x >= lower) & (x < upper)
    x_norm = ((x - lower) / rng).clamp(0.0, 1.0 - _EPS)
    y_in, log_j_in = piecewise_quadratic_transform(x_norm, w_tilde, v_tilde,
                                                   inverse=inverse)
    out = torch.where(inside, y_in * rng + lower, x)
    if inverse:
        return out, None
    return out, torch.where(inside, log_j_in, torch.zeros_like(log_j_in))
