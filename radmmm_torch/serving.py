"""Serving: in-process two-stage TTS and the saved serving artifact.

Counterpart of ``radmmm_tpu/serving.py``. The JAX package exports
compiled programs, one per (batch, text) bucket and per frame bucket. The
port's artifact is a ``torch.save`` bundle of what rebuilds the model:
the configs, the state_dicts, the (batch, max_text) buckets and the
mel-frame buckets; on the card each stage then runs as a CUDA graph
(``utils/graphs.py``), one per input shape, which ``load_tts`` captures
for every bucket when it loads: stage A (``infer_durations``) per text
bucket, stage B (``infer_decode``, the vocoder and the int16
quantisation) per text bucket and frame bucket. A request copies its
padded arrays into the graph's inputs and launches it once a stage. The
flow's latent is drawn eagerly from the request's seed
(``RADMMMFlow.draw_residual``) into stage B's input, the bits
``infer_decode`` would draw from the same generator. On the CPU the same
functions run eagerly.

    # offline
    from radmmm_torch.serving import export_tts
    export_tts(model, "tts.pt", vocoder=generator,
               buckets=[(1, 32), (4, 96)], frame_buckets=(192, 384, 576, 800))

    # serving process
    from radmmm_torch.serving import load_tts
    tts = load_tts("tts.pt")                       # device="cuda"
    audio_or_mel, lens = tts(text_ids, text_lens, speaker_ids, accent_ids,
                             f0_mean, f0_std, seed)

A request of any shape within the buckets goes to the smallest covering
bucket: text is zero-padded, per-item arrays are batch-filled by repeating
row 0, and outputs are trimmed back. The fill rows take part in the
batch-global F0 statistics of ``infer_decode``, exactly as in the JAX
package. With frame buckets (version 2) the artifact runs two stages:
durations first, then the decoder at the smallest frame bucket covering
the request's real rows, which the host picks between the stages. Audio
is quantised to int16 PCM on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.utils import profiling
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import Graphed, GraphPool
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig

_FORMAT = "radmmm_torch.tts"


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _quantize_pcm(audio: torch.Tensor) -> torch.Tensor:
    return torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(
        torch.int16)


def _vocode(vocoder, mel, pcm_int16: bool):
    audio = vocoder(mel.to(next(vocoder.parameters()).dtype))
    return _quantize_pcm(audio) if pcm_int16 else audio


def _generator(device: torch.device, seed) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _to(device, *arrays, dtypes):
    return [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                            dtype=dt, device=device)
            for a, dt in zip(arrays, dtypes)]


_I32, _F32 = torch.int32, torch.float32


def _residual(model: TTSModel, batch: int, max_frames: int, sigma: float,
              seed, device) -> torch.Tensor:
    """The flow latent of a request: what ``infer_decode`` draws from a
    generator seeded with ``seed``."""
    return model.decoder.draw_residual(batch, max_frames, sigma,
                                       _generator(device, seed), device)


def _decode(model: TTSModel, vocoder, pcm_int16: bool, sigma: float,
            max_frames: int):
    """Stage B over a dict of device tensors -> (mel | audio, lens)."""
    def decode(x):
        out = model.infer_decode(
            x["txt_enc"], x["durations"], x["spk"], accent_ids=x["acc"],
            f0_mean=x["f0m"], f0_std=x["f0s"], sigma=sigma,
            max_frames=max_frames, residual=x["residual"])
        mel, lens = out["mel"], out["lens"].lengths
        if vocoder is not None:
            return _vocode(vocoder, mel, pcm_int16), lens
        return mel, lens
    return decode


def make_tts_fn(model: TTSModel, *, sigma: float = 0.8,
                max_frames: int = 1024, vocoder: Optional[Generator] = None,
                pcm_int16: bool = True, pool: Optional[GraphPool] = None):
    """text -> (mel | audio, lens) at one max_frames, on the model's
    device (a CUDA graph per request shape on the card, in ``pool``,
    one of its own by default).
    Audio comes back as int16 PCM unless ``pcm_int16=False``."""
    device = _device_of(model)
    decode = _decode(model, vocoder, pcm_int16, sigma, max_frames)

    def both(x):
        d = model.infer_durations(x["text"], x["text_lens"], x["spk"],
                                  accent_ids=x["acc"])
        return decode(dict(x, txt_enc=d["txt_enc"],
                           durations=d["durations"]))

    graphed = Graphed(both, pool, name="tts")

    @torch.inference_mode()
    def tts(text, text_lens, speaker_ids, accent_ids, f0_mean, f0_std,
            seed):
        text, text_lens, spk, acc, f0m, f0s = _to(
            device, text, text_lens, speaker_ids, accent_ids, f0_mean,
            f0_std, dtypes=(_I32, _I32, _I32, _I32, _F32, _F32))
        return graphed(dict(
            text=text, text_lens=text_lens, spk=spk, acc=acc, f0m=f0m,
            f0s=f0s, residual=_residual(model, text.shape[0], max_frames,
                                        sigma, seed, device)))

    return tts


def make_two_stage_fns(model: TTSModel, *, sigma: float = 0.8,
                       vocoder: Optional[Generator] = None,
                       pcm_int16: bool = True,
                       pool: Optional[GraphPool] = None):
    """Two-stage serving: (dur_fn, make_decode), each stage a CUDA graph
    per input shape on the card (in ``pool``, one of their own by
    default), its body between the device marks ``serve.stage_a`` or
    ``serve.stage_b`` (``utils/profiling.device_span``).

    Stage A ``dur_fn(text, text_lens, speaker_ids, accent_ids)`` ->
    (txt_enc, durations, n_frames). Stage B ``make_decode(max_frames)`` ->
    ``decode(txt_enc, durations, speaker_ids, accent_ids, f0_mean, f0_std,
    seed)`` -> (mel | audio, lens) at that frame bucket."""
    device = _device_of(model)

    def durations(x):
        with profiling.device_span("serve.stage_a", device):
            out = model.infer_durations(x["text"], x["text_lens"], x["spk"],
                                        accent_ids=x["acc"])
        return out["txt_enc"], out["durations"], out["n_frames"]

    stage_a = Graphed(durations, pool, name="stage_a")

    @torch.inference_mode()
    def dur_fn(text, text_lens, speaker_ids, accent_ids):
        text, text_lens, spk, acc = _to(
            device, text, text_lens, speaker_ids, accent_ids,
            dtypes=(_I32, _I32, _I32, _I32))
        return stage_a(dict(text=text, text_lens=text_lens, spk=spk,
                            acc=acc))

    def make_decode(max_frames: int):
        body = _decode(model, vocoder, pcm_int16, sigma, int(max_frames))

        def marked(x):
            with profiling.device_span("serve.stage_b", device):
                return body(x)

        stage_b = Graphed(marked, stage_a.pool,
                          name=f"stage_b_{int(max_frames)}")

        @torch.inference_mode()
        def decode(txt_enc, durations, speaker_ids, accent_ids, f0_mean,
                   f0_std, seed):
            spk, acc, f0m, f0s = _to(
                device, speaker_ids, accent_ids, f0_mean, f0_std,
                dtypes=(_I32, _I32, _F32, _F32))
            return stage_b(dict(
                txt_enc=txt_enc, durations=durations, spk=spk, acc=acc,
                f0m=f0m, f0s=f0s,
                residual=_residual(model, txt_enc.shape[0], int(max_frames),
                                   sigma, seed, device)))
        return decode

    return dur_fn, make_decode


def pick_bucket(frame_buckets: Sequence[int], need: int) -> int:
    """The smallest of the sorted ``frame_buckets`` that holds ``need``
    frames; over the largest, the largest (the decode clamps there)."""
    return next((f for f in frame_buckets if f >= need), frame_buckets[-1])


class TwoStageTTS:
    """In-process two-stage bucketed TTS (same 7-argument call as
    make_tts_fn's function): stage A, a fetch of n_frames, stage B at the
    smallest frame bucket covering the batch."""

    def __init__(self, model: TTSModel,
                 frame_buckets: Sequence[int] = (192, 384, 576, 800), **kw):
        self.dur, make_decode = make_two_stage_fns(model, **kw)
        self.frame_buckets = sorted(int(f) for f in frame_buckets)
        self.decode = {f: make_decode(f) for f in self.frame_buckets}

    def pick_bucket(self, n_frames) -> int:
        return pick_bucket(self.frame_buckets,
                           int(torch.as_tensor(n_frames).max()))

    def __call__(self, text, text_lens, speaker_ids, accent_ids, f0_mean,
                 f0_std, seed):
        txt_enc, durations, n_frames = self.dur(text, text_lens, speaker_ids,
                                                accent_ids)
        mf = self.pick_bucket(n_frames)
        return self.decode[mf](txt_enc, durations, speaker_ids, accent_ids,
                               f0_mean, f0_std, seed)


def _cpu_state(module: torch.nn.Module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def export_tts(model: TTSModel, path: str, *, batch_size: int = 8,
               max_text: int = 96, sigma: float = 0.8, max_frames: int = 1024,
               vocoder: Optional[Generator] = None,
               buckets: Optional[Sequence[Tuple[int, int]]] = None,
               frame_buckets: Optional[Sequence[int]] = None) -> int:
    """Write the serving artifact to ``path``; returns its size in bytes.

    ``buckets`` lists (batch, max_text) pairs (default one bucket,
    (batch_size, max_text)). With ``frame_buckets`` the artifact is
    two-stage (version 2); otherwise it decodes at ``max_frames``
    (version 1)."""
    bucket_list = [(int(b), int(t))
                   for b, t in (buckets or [(batch_size, max_text)])]
    bundle = {
        "format": _FORMAT,
        "version": 2 if frame_buckets else 1,
        "tts_config": dataclasses.asdict(model.config),
        "tts_state": _cpu_state(model),
        "vocoder_config": (dataclasses.asdict(vocoder.config)
                           if vocoder is not None else None),
        "vocoder_state": _cpu_state(vocoder) if vocoder is not None else None,
        "buckets": bucket_list,
        "frame_buckets": (sorted(int(f) for f in frame_buckets)
                          if frame_buckets else None),
        "sigma": float(sigma),
        "max_frames": int(max_frames),
    }
    torch.save(bundle, path)
    with open(path, "rb") as f:
        return len(f.read())


def _pad_request(buckets, text, per_item):
    """Pick the smallest covering (B, T) bucket and pad the request to it:
    text zero-padded, per-item arrays batch-filled by replicating row 0
    (always a valid item; its outputs are sliced away by the caller)."""
    text = np.asarray(text)
    b, t = text.shape
    fit = [(B, T) for B, T in buckets if B >= b and T >= t]
    if not fit:
        raise ValueError(
            f"request shape ({b}, {t}) exceeds every exported bucket "
            f"{buckets}")
    B, T = fit[0]
    pad_rows = B - b
    text_p = np.zeros((B, T), text.dtype)
    text_p[:b, :t] = text
    if pad_rows:
        text_p[b:] = text_p[:1]
    padded = []
    for a in per_item:
        a = np.asarray(a)
        padded.append(np.concatenate(
            [a, np.repeat(a[:1], pad_rows, axis=0)]) if pad_rows else a)
    return (B, T), b, text_p, padded


def load_tts(path: str, device: str = "cuda"):
    """Rebuild the serving callable from an artifact written by export_tts.

    The callable takes (text, text_lens, speaker_ids, accent_ids, f0_mean,
    f0_std, seed) of any shape within the buckets and returns
    (int16 audio | mel, lens) as tensors on ``device``. It exposes
    ``buckets``, ``frame_buckets`` (None for version 1), ``output_kind``
    ('audio' | 'mel') and ``device``. The artifact holds no precision:
    each call runs at this process's conv precision
    (``ops.conv.set_conv_precision``, ``RADMMM_CONV_PRECISION=bf16``),
    where a JAX package's exported program keeps the one it was traced
    at."""
    dev = resolve_device(device)
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    if bundle.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a radmmm_torch serving artifact")
    model = TTSModel(TTSConfig(**bundle["tts_config"]))
    model.load_state_dict(bundle["tts_state"])
    model.to(dev).eval().cache_inverses()
    vocoder = None
    if bundle["vocoder_config"] is not None:
        vocoder = Generator(HiFiGANConfig(**bundle["vocoder_config"]))
        vocoder.load_state_dict(bundle["vocoder_state"])
        vocoder.to(dev).eval()

    buckets = sorted((tuple(bt) for bt in bundle["buckets"]),
                     key=lambda bt: bt[0] * bt[1])
    frame_buckets = bundle["frame_buckets"]
    sigma = bundle["sigma"]
    pool = GraphPool() if dev.type == "cuda" else None
    if frame_buckets:
        dur_fn, make_decode = make_two_stage_fns(model, sigma=sigma,
                                                 vocoder=vocoder, pool=pool)
        decodes = {f: make_decode(f) for f in frame_buckets}

        def run(text_p, text_lens, spk, acc, f0m, f0s, seed, b):
            with profiling.span("serving.stage_a"):
                txt_enc, durations, n_frames = dur_fn(text_p, text_lens,
                                                      spk, acc)
            with profiling.span("serving.bucket_pick"):
                # only n_frames crosses to the host; real rows only (the
                # batch fill repeats row 0, already covered by it)
                need = int(n_frames[:b].max())
                F = pick_bucket(frame_buckets, need)
                profiling.count("serve.frames_needed", need)
                profiling.count("serve.frames_bucket", F)
            with profiling.span("serving.stage_b"):
                return decodes[F](txt_enc, durations, spk, acc, f0m, f0s,
                                  seed)
    else:
        tts = make_tts_fn(model, sigma=sigma,
                          max_frames=bundle["max_frames"], vocoder=vocoder,
                          pool=pool)

        def run(text_p, text_lens, spk, acc, f0m, f0s, seed, b):
            return tts(text_p, text_lens, spk, acc, f0m, f0s, seed)

    def call(text, text_lens, speaker_ids, accent_ids, f0_mean, f0_std,
             seed):
        with profiling.span("serving.pad"):
            _, b, text_p, per_item = _pad_request(
                buckets, text, (text_lens, speaker_ids, accent_ids, f0_mean,
                                f0_std))
        out, lens = run(text_p, *per_item, seed, b)
        return out[:b], lens[:b]

    if pool is not None:
        # every bucket's graphs, captured now rather than at a first
        # request: two dummy requests of each (batch, text) bucket through
        # stage A and each frame bucket's stage B (a graph's first call at
        # a signature warms up, its second captures)
        for B, T in buckets * 2:
            text = np.zeros((B, T), np.int32)
            per_item = (np.full(B, T, np.int32), np.zeros(B, np.int32),
                        np.zeros(B, np.int32), np.zeros(B, np.float32),
                        np.ones(B, np.float32))
            if frame_buckets:
                txt_enc, durations, _ = dur_fn(text, *per_item[:3])
                for f in frame_buckets:
                    decodes[f](txt_enc, durations, *per_item[1:], 0)
            else:
                tts(text, *per_item, 0)
        torch.cuda.synchronize()

    call.buckets = buckets
    call.frame_buckets = frame_buckets
    call.output_kind = "audio" if vocoder is not None else "mel"
    call.device = dev
    # the captured graphs (None on the CPU): each capture's seconds, bytes
    # and launches
    call.graphs = pool
    return call
