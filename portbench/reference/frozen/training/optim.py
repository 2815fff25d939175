"""The optimizer: exact RAdam after a global-norm clip (a frozen copy of
the port's ``training/optim.py``, cut to the RAdam of the benchmark's
configurations: no AdamW, no frozen or model-split parameters, no state
dict).

Counterpart of ``radmmm_tpu/training/optim.py``. The reference insists on
the original Liu et al. RAdam rather than a framework's built-in, whose
below-threshold branch differs; ``torch.optim.RAdam`` divides by the second
moment there too. So the update is written out here:

* the variance-rectified step when the SMA length N_sma >= 5,
* a plain momentum SGD step (no second-moment denominator) otherwise,
* weight decay applied to the parameters with the update
  (p -= wd * lr * p).

Gradients are clipped to a global norm first (optax.clip_by_global_norm:
unchanged below the limit, g / norm * limit above it). The arithmetic runs
as multi-tensor ``torch._foreach_*`` ops over every parameter at once;
the step's scalars (bias corrections, rectification) are float32, as in
the JAX package.

A step is two halves: ``prepare`` on the host advances the count, computes
the step's float32 scalars in numpy and writes them into a small tensor
on the parameters' device (one fill each); ``apply`` is device work only,
reading that tensor, so a CUDA graph of it (``utils/graphs.py``) replays
with each step's scalars. ``prepare`` returns whether RAdam takes the
rectified branch, which changes the ops ``apply`` runs: a graph is keyed
on it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch


class Optimizer:
    """``step()`` reads every parameter's ``.grad`` (None counts as zero),
    clips, updates the parameters in place and returns the global norm of
    the gradients before the clip (a 0-d tensor on their device)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], algo: str,
                 learning_rate: float, weight_decay: float = 0.0,
                 grad_clip_val: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if algo != "RAdam":
            raise ValueError(f"Unrecognized optimizer {algo}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.algo = algo
        self.lr, self.wd, self.clip = learning_rate, weight_decay, grad_clip_val
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        # the step's float32 scalars on the parameters' device, written by
        # prepare and read by apply; rectified: RAdam's branch of the step
        self.scalars: Optional[torch.Tensor] = None
        self.rectified = True
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _global_norm(self, grads) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        self.prepare()
        return self.apply()

    def prepare(self) -> bool:
        """The host half of a step: advance the count and write the step's
        float32 scalars into ``self.scalars``. Returns True where RAdam
        takes the rectified branch (N_sma >= 5)."""
        self.count += 1
        t = np.float32(self.count)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bias1 = np.float32(1) - b1 ** t
        beta2_t = b2 ** t
        # the constants in float64, then float32 arithmetic in the JAX
        # package's order: n_sma cancels (1999 - 1993 at step 6), so a
        # rounding here moves the whole step
        n_sma_max = 2.0 / (1 - self.b2) - 1.0
        f32 = np.float32
        n_sma = f32(n_sma_max) - f32(2) * t * beta2_t / (f32(1) - beta2_t)
        self.rectified = bool(n_sma >= 5.0)
        if self.rectified:
            rect = np.sqrt((f32(1) - beta2_t) * (n_sma - f32(4))
                           / f32(n_sma_max - 4) * (n_sma - f32(2))
                           / n_sma * f32(n_sma_max)
                           / f32(n_sma_max - 2))
            values = (self.lr * rect / bias1,)
        else:
            values = (self.lr / bias1,)
        if self.scalars is None or self.scalars.device != self.params[0].device:
            self.scalars = torch.zeros(2, dtype=torch.float32,
                                       device=self.params[0].device)
        for i, v in enumerate(values):
            self.scalars[i].fill_(float(np.float32(v)))
        return self.rectified

    @torch.no_grad()
    def apply(self) -> torch.Tensor:
        """The device half of a step (after ``prepare``): clip, update the
        moments and the parameters in place; returns the global norm of
        the gradients before the clip."""
        grads = self._grads()
        params, exp_avg, exp_avg_sq = self.params, self.exp_avg, self.exp_avg_sq
        total = norm = self._global_norm(grads)
        if self.clip:
            # below the limit the gradients pass unchanged
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(exp_avg, self.b1)
        torch._foreach_add_(exp_avg, grads, alpha=1 - self.b1)
        torch._foreach_mul_(exp_avg_sq, self.b2)
        torch._foreach_addcmul_(exp_avg_sq, grads, grads,
                                value=1 - self.b2)
        # scalars[0]: lr * rect / bias1 (rectified) or lr / bias1
        delta = torch._foreach_mul(exp_avg, self.scalars[0])
        if self.rectified:
            denom = torch._foreach_sqrt(exp_avg_sq)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(delta, denom)
        if self.wd:
            torch._foreach_add_(delta, params, alpha=self.wd * self.lr)
        torch._foreach_sub_(params, delta)
        return total


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optim_algo: str = "RAdam", learning_rate: float = 1e-4,
                    weight_decay: float = 1e-6,
                    grad_clip_val: Optional[float] = 1.0) -> Optimizer:
    """RAdam (exact), after a global-norm clip to ``grad_clip_val`` (none
    when it is 0 or None)."""
    return Optimizer(params, optim_algo, learning_rate, weight_decay,
                     grad_clip_val)
