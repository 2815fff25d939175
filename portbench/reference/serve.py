"""The plain reference of a serving cell: the frozen acoustic model and
HiFi-GAN generator (``reference/frozen``) on the benchmark's weights,
computing a request as the served artifact does (text padded to the
request's bucket, stage A's durations, the frame bucket picked from them,
the flow latent drawn from the request's seed at that bucket, stage B,
the vocoder, int16 PCM trimmed to each item's frames)."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from portbench import weights
from portbench.reference.frozen.models.tts import TTSConfig, TTSModel
from portbench.reference.frozen.utils.masking import SeqLens
from portbench.reference.frozen.vocoder.hifigan import (Generator,
                                                        HiFiGANConfig)
from portbench.reference.train import tf32

# a token whose unrounded duration lies this close to a rounding
# boundary may round either way in f32 arithmetic of another order
ROUNDING_BAND = 1e-3
TOKEN_DURATION_MAX = 100


def vocoder_config(cs: Dict[str, Any]) -> HiFiGANConfig:
    return HiFiGANConfig.from_dict(cs["vocoder"])


def states(cs: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The acoustic model's and the vocoder's weights from ``seed``, with
    the frozen models they were drawn for."""
    model = weights.build_on(device, TTSModel, TTSConfig(**cs["tts"]))
    voc = weights.build_on(device, Generator, vocoder_config(cs))
    # the vocoder's entries are drawn from a stream of their own
    return {"model": model, "vocoder": voc,
            "tts_state": weights.draw_state(model, seed, device,
                                            cs["weights"]),
            "vocoder_state": weights.draw_state(
                voc, int(np.random.SeedSequence([int(seed), 5])
                         .generate_state(1)[0]), device,
                cs.get("vocoder_weights") or {})}


class Reference:
    def __init__(self, cs: Dict[str, Any], seed: int, device):
        made = states(cs, seed, device)
        self.model, self.voc = made["model"], made["vocoder"]
        self.model.load_state_dict(made["tts_state"])
        self.voc.load_state_dict(made["vocoder_state"])
        self.model.eval()
        self.voc.eval()
        self.sigma = float(cs["serving"]["sigma"])
        self.hop = int(cs["serving"]["hop_length"])
        self.device = device

    @torch.no_grad()
    def __call__(self, req: Dict[str, Any], bucket: Sequence[int],
                 frame_buckets: Sequence[int], lower_precision: bool = False
                 ) -> Dict[str, Any]:
        """{"frames": each item's frames, "ambiguous": each item's tokens
        whose duration lies within ROUNDING_BAND of a rounding boundary,
        "pcm": each item's int16 PCM}."""
        dev = self.device
        seqs = req["text_ids"]
        b = len(seqs)
        B, T = bucket
        text = np.zeros((B, T), np.int32)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            text[i, :len(s)] = s
            lens[i] = len(s)
        text[b:] = text[:1]
        lens[b:] = lens[:1]

        def rows(key):
            a = np.asarray(req[key])
            a = np.full(b, a) if a.ndim == 0 else a
            return np.concatenate([a, np.repeat(a[:1], B - b)])
        spk = torch.as_tensor(rows("speaker_id"), dtype=torch.int32,
                              device=dev)
        acc = torch.as_tensor(rows("accent_id"), dtype=torch.int32,
                              device=dev)
        f0m = torch.as_tensor(rows("f0_mean"), dtype=torch.float32,
                              device=dev)
        f0s = torch.as_tensor(rows("f0_std"), dtype=torch.float32,
                              device=dev)
        text_t = torch.as_tensor(text, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        m = self.model
        with tf32(lower_precision):
            in_lens = SeqLens.create(lens_t, T)
            accent_vecs = (m.accent_embeddings(acc) if m.config.use_accent
                           else None)
            txt_enc, _ = m.encode_text(text_t, in_lens, accent_vecs)
            raw = m.duration_predictor.infer(
                txt_enc, m.speaker_embeddings(spk), in_lens,
                accent_emb=accent_vecs)[..., 0]
            dur = torch.clamp(torch.round(raw), 1, TOKEN_DURATION_MAX)
            dur = (dur * in_lens.fmask(dur.dtype)).to(torch.int32)
            frames = dur.sum(-1).cpu().numpy()
            need = int(frames[:b].max())
            F = next((f for f in frame_buckets if f >= need),
                     frame_buckets[-1])
            gen = torch.Generator(device=dev).manual_seed(int(req["seed"]))
            residual = m.decoder.draw_residual(B, F, self.sigma, gen, dev)
            out = m.infer_decode(txt_enc, dur, spk, accent_ids=acc,
                                 f0_mean=f0m, f0_std=f0s, sigma=self.sigma,
                                 max_frames=F, residual=residual)
            audio = self.voc(out["mel"])
        pcm = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(
            torch.int16).cpu().numpy()
        n_out = out["lens"].lengths.cpu().numpy()
        frac = (raw - torch.floor(raw)).cpu().numpy()
        near = (np.abs(frac - 0.5) < ROUNDING_BAND) \
            & (raw.cpu().numpy() > 1.0) & in_lens.mask.cpu().numpy()
        return {"frames": [int(x) for x in n_out[:b]],
                "ambiguous": [int(x) for x in near.sum(-1)[:b]],
                "pcm": [pcm[i, :int(n_out[i]) * self.hop] for i in range(b)],
                "bucket_frames": F}


def pcm_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The RMS of the difference of two int16 PCM arrays over the RMS of
    the reference's (inf where their lengths differ)."""
    if got.shape != want.shape:
        return float("inf")
    d = got.astype(np.float64) - want.astype(np.float64)
    ref = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return float(np.sqrt(np.mean(d ** 2)) / max(ref, 1.0))


def serve_numbers(served: List[Dict[str, Any]], refs: List[Dict[str, Any]]
                  ) -> Dict[str, float]:
    """The serving cell's compared numbers over sampled requests:
    ``frames_gap``, the largest count of an item's frames off the
    reference's beyond its tokens that lie on a rounding boundary; and
    ``pcm_gap``, the largest relative RMS gap of an item's PCM over the
    items whose frames and durations are unambiguous."""
    frames_gap, gap, n = 0, 0.0, 0
    for s, r in zip(served, refs):
        for i, pcm in enumerate(s["pcm"]):
            off = abs(int(s["frames"][i]) - r["frames"][i])
            frames_gap = max(frames_gap, off - r["ambiguous"][i])
            if off == 0 and r["ambiguous"][i] == 0:
                gap = max(gap, pcm_gap(pcm, r["pcm"][i]))
                n += 1
    return {"frames_gap": float(max(frames_gap, 0)),
            "pcm_gap": gap if n else float("inf"), "pcm_items": n}
