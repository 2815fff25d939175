"""The operation and byte counters against hand counts at small
shapes."""
import math

import torch

from portbench import bounds
from portbench.reference.frozen.ops.conv import MaskedConv1d
from portbench.reference.frozen.ops.lstm import MaskedLSTM


def test_lstm_bounds_by_hand():
    # L 2, T 4, B 3, H 5, 10 valid frames: bytes 4 (L T B 4H + T B + L H 4H
    # + L T B H 7) against 8 H^2 L valid FLOP
    n_bytes = 4 * (2 * 4 * 3 * 20 + 12 + 2 * 5 * 20 + 2 * 4 * 3 * 5 * 7)
    want = max(n_bytes / 3.35e12, 8 * 25 * 2 * 10 / 67e12) * 1e3
    assert math.isclose(bounds.bound_ms(2, 4, 3, 5, 10, save=True), want)
    n_bytes = 4 * (2 * 4 * 3 * 5 * 2 + 2 * 4 * 3 * 20 * 2 + 12 + 2 * 5 * 20)
    want = max(n_bytes / 3.35e12, 8 * 25 * 2 * 10 / 67e12) * 1e3
    assert math.isclose(bounds.bound_bwd_ms(2, 4, 3, 5, 10), want)


def test_dp_bounds_by_hand():
    # items of (3 tokens, 5 frames) and (2, 4): (7*5 + 5*4) states by
    # frames, each read and written once, f32
    assert math.isclose(bounds.ctc_bound_ms([3, 2], [5, 4]),
                        8 * (35 + 20) / 3.35e12 * 1e3)
    assert math.isclose(bounds.mas_bound_ms([3, 2], [5, 4]),
                        8 * (15 + 8) / 3.35e12 * 1e3)


def test_model_macs_by_hand():
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = MaskedConv1d(4, 6, 3)
            self.lstm = MaskedLSTM(6, 5)
            self.dec = MaskedConv1d(6, 2, 1)

    table = dict(bounds.model_macs_per_step(Tiny()))
    assert table["enc"] == 6 * 4 * 3
    assert table["lstm"] == 2 * (6 * 20 + 5 * 20)
    assert table["dec"] == 2 * 6
    spec = {"axes": {"enc": "text", "lstm": "text", "dec": "mel_group"},
            "group": 2, "skip_in_inference": ["dec"],
            "extra": [{"axis": "text*mel", "mac": 3,
                       "training_only": True}]}
    lens = [(4, 10), (2, 6)]
    fwd = sum((72 + 440) * n + 12 * (m // 2) + 3 * n * m for n, m in lens)
    assert bounds.tts_flops(list(table.items()), spec, lens, False) \
        == 2 * 3 * fwd
    inf = sum((72 + 440) * n for n, m in lens)
    assert bounds.tts_flops(list(table.items()), spec, lens, True) == 2 * inf


def test_hifigan_flops_by_hand():
    voc = {"upsample_rates": [2], "upsample_kernel_sizes": [4],
           "upsample_initial_channel": 8, "n_mel_channels": 3,
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
           "resblock": "1"}
    m = 5
    mac = m * 3 * 8 * 7 + m * 8 * 4 * 4 + 4 * (2 * m) * 4 * 4 * 3 \
        + (2 * m) * 4 * 7
    assert bounds.hifigan_flops(voc, [m]) == 2 * mac
