"""A cell cut to a size that a CPU test run holds: the tests' tiny model
(tests/test_tts_model.py's) in place of the configuration's, few and
short utterances, a short window."""
from __future__ import annotations

import copy
from typing import Any, Dict

from portbench import harness

DAP = dict(n_speaker_dim=4, n_accent_dim=2, use_accent_embedding=True,
           in_dim=18, out_dim=1, reduction_factor=2, n_backbone_layers=1,
           n_hidden=8, kernel_size=3, p_dropout=0.25, lstm_type="bilstm")
TTS = dict(
    n_text_tokens=30, n_text_dim=16, n_speakers=3, n_speaker_dim=4,
    n_augmentations=0, use_accent=True, n_accents=2, n_accent_dim=2,
    n_mel_channels=8, use_accent_emb_for_encoder=True,
    use_speaker_emb_for_alignment=True, lstm_norm_fn="spectral",
    decoder=dict(n_speaker_dim=4, use_accent=True, n_accent_dim=2,
                 n_text_dim=18, use_context_lstm=True, n_f0_dims=1,
                 n_energy_avg_dims=1, n_mel_channels=8, n_flows=2,
                 n_conv_layers_per_step=1, n_early_size=2, n_early_every=2,
                 n_group_size=2, affine_model="wavenet", scaling_fn="tanh",
                 use_partial_padding=True),
    f0_predictor=dict(DAP, target_offset=-5.0),
    energy_predictor=dict(DAP, target_offset=-0.75),
    voiced_predictor=dict(DAP), duration_predictor=dict(DAP, log_target=True))
VOCODER = dict(resblock="1", upsample_rates=[8, 8, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4],
               upsample_initial_channel=16, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]], n_mel_channels=8,
               sampling_rate=22050, gen_istft_n_fft=None, gen_istft_hop=4)


def tiny_cell(name: str) -> Dict[str, Any]:
    cell = copy.deepcopy(harness.workload(name))
    cs = cell["config_spec"]
    cs["tts"] = copy.deepcopy(TTS)
    cs["featurizer"]["n_mel_channels"] = 8
    if cs.get("vocoder"):
        cs["vocoder"] = copy.deepcopy(VOCODER)
        # the narrow generator's output gain raised to an audible level
        cs["vocoder_weights"] = {"fill": {"^conv_post_g$": 3e4}}
    t = cell["traffic"]
    if t["kind"] == "train":
        # a batch for each compared step
        t.update(batch=2, pool=8, frames=[8, 16], text=[4, 8],
                 pad_to=[16, 8])
    else:
        t.update(requests=6, seconds=dict(min=0.3, mode=0.6, max=0.8),
                 tokens_per_second=10.0, sample=3,
                 buckets=[[b, 8] for b, _ in t["buckets"]],
                 frame_buckets=[32, 64, 128])
    return cell
