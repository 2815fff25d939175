"""The yardstick's arithmetic: the H100's published peaks, the least time
of a kernel's work, and the operations of a training step or a served
request counted from the configuration and the valid lengths.

``bound_ms`` and ``bound_bwd_ms`` are frozen copies of ``chip_smoke.py``'s
(K4 and K4-bwd). The operation counts walk the frozen reference model
(``reference/frozen``), never the program's, so that a change to the
program's modules cannot change the count.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence

# NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12


def least_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_F32_FLOP_PER_S) -> float:
    """The least ms of the work: its bytes at the HBM rate or its
    operations at the peak rate, whichever takes longer."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / peak_flops) * 1e3


def bound_ms(L, T, B, H, valid_frames, save=False) -> float:
    """K4: each input read once, the output (and in training the saved
    gates, c and h) written once; 8H^2 FLOP per (lane, valid frame) for
    h @ Wh."""
    n_out = L * T * B * H * (7 if save else 1)
    n_bytes = 4 * (L * T * B * 4 * H + T * B + L * H * 4 * H + n_out)
    return least_ms(n_bytes, 8.0 * H * H * L * valid_frames)


def bound_bwd_ms(L, T, B, H, valid_frames) -> float:
    """K4-bwd reads dout, the saved gates and c, the mask and Wh and
    writes dgates; 8H^2 FLOP per (lane, valid frame) for dgates @ Wh^T."""
    n_bytes = 4 * (L * T * B * H * 2 + L * T * B * 4 * H * 2 + T * B
                   + L * H * 4 * H)
    return least_ms(n_bytes, 8.0 * H * H * L * valid_frames)


def ctc_bound_ms(text_lens: Sequence[int], mel_lens: Sequence[int]) -> float:
    """K1 or K2: the band's emissions read once and its rows written
    once, (2 n + 1) states by m frames an item, f32."""
    cells = sum((2 * n + 1) * m for n, m in zip(text_lens, mel_lens))
    return least_ms(4.0 * 2 * cells, 0.0)


def mas_bound_ms(text_lens: Sequence[int], mel_lens: Sequence[int]) -> float:
    """K3: the log attention read once and the hard alignment written
    once, n by m an item, f32."""
    cells = sum(n * m for n, m in zip(text_lens, mel_lens))
    return least_ms(4.0 * 2 * cells, 0.0)


def _axis_of(path: str, axes: Dict[str, str]) -> str:
    best = max((p for p in axes if path.startswith(p)), key=len,
               default=None)
    if best is None:
        raise KeyError(f"no time axis in the configuration for {path}")
    return axes[best]


def model_macs_per_step(model) -> List[tuple]:
    """(module path, multiply-adds per time step) of every module of the
    frozen model that holds weights and multiplies by them."""
    out = []
    for path, m in model.named_modules():
        kind = type(m).__name__
        own = dict(m.named_parameters(recurse=False))
        if not own:
            continue
        if kind == "MaskedLSTM":
            mac = sum(own[f"wi_{d}"].shape[0] * own[f"wi_{d}"].shape[1]
                      + own[f"wh_{d}"].shape[0] * own[f"wh_{d}"].shape[1]
                      for d in m.dirs)
        elif kind in ("InvertibleLU", "WhiteningConv"):
            mac = own["upper"].shape[0] ** 2
        elif "v" in own and own["v"].dim() == 3:
            mac = own["v"].numel()
        elif "weight" in own and own["weight"].dim() in (2, 3) \
                and kind != "Embedding":
            mac = own["weight"].numel()
        else:
            continue
        out.append((path, mac))
    return out


def axis_length(axis: str, n_text: int, n_mel: int, group: int) -> int:
    return {"text": n_text, "mel": n_mel, "mel_group": n_mel // group,
            "text*mel": n_text * n_mel, "none": 0}[axis]


def tts_flops(table: List[tuple], flop_spec: Dict,
              lengths: Iterable[tuple], inference: bool) -> float:
    """FLOP (2 per multiply-add) of the acoustic model's products over
    items of valid (text, mel) lengths: forward only for ``inference``
    (the configuration's ``skip_in_inference`` modules left out), or
    forward plus a backward at twice the forward's products."""
    axes, group = flop_spec["axes"], int(flop_spec["group"])
    skip = [re.compile(p) for p in flop_spec.get("skip_in_inference", [])]
    total = 0.0
    for n, m in lengths:
        for path, mac in table:
            if inference and any(s.match(path) for s in skip):
                continue
            total += mac * axis_length(_axis_of(path, axes), n, m, group)
        for extra in flop_spec.get("extra", []):
            if inference and extra.get("training_only"):
                continue
            total += extra["mac"] * axis_length(extra["axis"], n, m, group)
    return 2.0 * total * (1.0 if inference else 3.0)


def hifigan_flops(voc: Dict, frames: Iterable[int]) -> float:
    """FLOP of the HiFi-GAN generator's convolutions over mels of the
    given frames: conv_pre at the frame rate, each transposed conv over
    its input steps (C_in C_out K a step), each resblock conv at its
    stage's rate, conv_post at the sample rate."""
    rates, kernels = voc["upsample_rates"], voc["upsample_kernel_sizes"]
    c0 = voc["upsample_initial_channel"]
    mels = voc["n_mel_channels"]
    total = 0.0
    for m in frames:
        t, c = m, c0
        mac = t * mels * c0 * 7
        for r, k in zip(rates, kernels):
            mac += t * c * (c // 2) * k
            t, c = t * r, c // 2
            for rk, dil in zip(voc["resblock_kernel_sizes"],
                               voc["resblock_dilation_sizes"]):
                n_conv = 2 * len(dil) if voc["resblock"] == "1" else len(dil)
                mac += n_conv * t * c * c * rk
        mac += t * c * 1 * 7
        total += mac
    return 2.0 * total
