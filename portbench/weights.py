"""Weights from a seed, by parameter name, on the device.

The benchmark makes the weights and hands the same state dict to the
program and to the plain reference. Every entry that the model draws at
random when it is built (its parameters, and the spectral norms' ``u``
buffers) is redrawn here: one normal draw of all of them in a single call
of a seeded ``torch.Generator`` on the card, laid out by sorted name, each
entry scaled to the mean and spread that the frozen reference model
(``reference/frozen``) gives it when built under a fixed seed. The
entries the model builds without drawing (constants, the invertible 1x1s'
LU factors from their own fixed seeds, buffers) keep the frozen model's
values, as does an entry of one value. So the weights depend on the seed and the names alone: not on the
order in which any version of the program creates its modules. The
configuration's ``weights`` section sets entries by name pattern:
``keep`` leaves the frozen model's values (entries it builds without
drawing, such as the invertible 1x1s' LU factors of a fixed seed),
``scale`` draws them at a given spread around 0 and ``fill`` sets a
constant.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import torch

# the seed under which the frozen model is built for its entries' means
# and spreads
STATS_SEED = 0
SN_BUFFER = re.compile(r"\.sn_(fwd|bwd)\.u$")


def _entries_to_draw(model: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    params = dict(model.named_parameters())
    out = []
    for name, t in sd.items():
        if not t.is_floating_point():
            continue
        if name in params or SN_BUFFER.search(name):
            out.append(name)
    return sorted(out)


def draw_state(frozen_model: torch.nn.Module, seed: int, device,
               rules: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``frozen_model``'s names drawn from ``seed``
    (see the module docstring); ``frozen_model`` was built under
    ``torch.manual_seed(STATS_SEED)``."""
    base = {k: v.detach().to(device) for k, v in
            frozen_model.state_dict().items()}
    names = _entries_to_draw(frozen_model, base)
    scale_rules = [(re.compile(p), float(s))
                   for p, s in rules.get("scale", {}).items()]
    fill_rules = [(re.compile(p), float(v))
                  for p, v in rules.get("fill", {}).items()]
    keep_rules = [re.compile(p) for p in rules.get("keep", [])]
    names = [n for n in names if not any(p.search(n) for p in keep_rules)]
    total = sum(base[n].numel() for n in names)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    out = dict(base)
    off = 0
    for n in names:
        t = base[n]
        zi = z[off:off + t.numel()].view_as(t)
        off += t.numel()
        fill = next((v for p, v in fill_rules if p.search(n)), None)
        if fill is not None:
            out[n] = torch.full_like(t, fill)
            continue
        spread = next((s for p, s in scale_rules if p.search(n)), None)
        if spread is not None:
            out[n] = zi * spread
        elif t.numel() < 2:
            # a one-entry leaf has no spread to copy: it keeps the value
            # the frozen model builds under the fixed seed
            out[n] = t.clone()
        else:
            out[n] = t.mean() + t.std() * zi
    del z
    return out


def build_on(device, build, *args, **kw) -> torch.nn.Module:
    """``build(*args, **kw)`` (a model constructor) on ``device`` under
    the fixed statistics seed, moved whole to ``device``; the caller's
    RNG state is restored."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(STATS_SEED)
        with torch.device(device):
            return build(*args, **kw).to(device)
