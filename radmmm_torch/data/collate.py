"""Host collation, length bucketing and the device featurizer.

Counterpart of ``radmmm_tpu/data/collate.py``. ``collate_host`` pads raw
audio and text into bucketed numpy arrays; ``Featurizer`` then computes
the log-mel, the pYIN F0 with its voicing, the energy and the
beta-binomial alignment prior for the whole batch on the device, giving
the batch a training step takes (``training/step.make_train_step``).
``BucketBatcher`` groups utterances of similar length into batches.

Mel noise is drawn from a ``torch.Generator`` seeded with a key derived
from (seed, process index, step) by numpy's ``SeedSequence``: fresh noise
on every call, and a key per trainer step that replays. The process index
is the rank's index in the data group of the active ``parallel.mesh`` (0
in one process), so ranks that load other batches draw other noise and
ranks of one model group draw the same. The bits differ from the JAX
package's, the schedule is the same.

The JAX package jits the featurizer. Here a call on the card
(``Featurizer.__call__``, the loaders' featurize) runs through
``utils/graphs.Graphed`` in a pool of the featurizer's own: one CUDA
graph per signature (the batch's shapes, whether it carries F0 cache
tracks and mel noise, the F0 method), the first call at a signature its
eager warm-up, the second its capture, later calls replays. The arrays
go up from pinned memory, without blocking, on the pool's stream, the mel
noise is drawn there eagerly and passed in, and the batch is handed to
the calling thread's stream: that stream waits for the replay, and the
batch's memory is not reused before that stream is done with it. The
training and the validation loaders' threads may call one featurizer at
once, so a call holds the featurizer's lock from the noise key to the
hand-over.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from radmmm_torch.data.pitch import pyin_f0, yin_f0
from radmmm_torch.parallel import mesh
from radmmm_torch.ops.priors import beta_binomial_prior
from radmmm_torch.ops.stft import MelSpectrogram
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import (OWN_POOL, GraphPool, graph_program,
                                       own_pool)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def collate_host(items: Sequence[Optional[Dict[str, Any]]],
                 hop_length: int = 256, audio_frames_multiple: int = 64,
                 text_multiple: int = 16,
                 pad_to: Optional[tuple] = None
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Pad dataset items into bucketed numpy arrays. None items (broken
    audio) are dropped. ``pad_to=(mel_frames, text_tokens)`` pins the
    padded shape, clipping longer items; otherwise the audio is padded so
    the mel frames land on a multiple of ``audio_frames_multiple`` and the
    text on a multiple of ``text_multiple``."""
    items = [x for x in items if x is not None]
    if not items:
        return None
    B = len(items)
    audio_lens = np.array([len(x["audio"]) for x in items], np.int32)
    text_lens = np.array([len(x["text_encoded"]) for x in items], np.int32)

    if pad_to is not None:
        max_frames, T_text = int(pad_to[0]), int(pad_to[1])
        T_audio = max_frames * hop_length
        audio_lens = np.minimum(audio_lens, T_audio)
        text_lens = np.minimum(text_lens, T_text)
    else:
        max_frames = round_up(1 + int(audio_lens.max()) // hop_length,
                              audio_frames_multiple)
        T_audio = max_frames * hop_length
        T_text = round_up(int(text_lens.max()), text_multiple)

    audio = np.zeros((B, T_audio), np.float32)
    text = np.zeros((B, T_text), np.int32)
    for i, x in enumerate(items):
        audio[i, :audio_lens[i]] = x["audio"][:audio_lens[i]]
        text[i, :text_lens[i]] = x["text_encoded"][:text_lens[i]]

    out_extra = {}
    tracks = [x.get("cached_f0") for x in items]
    if all(t is not None for t in tracks):
        # precomputed (3, F) [f0, voiced, p_voiced] tracks: the featurizer
        # skips pYIN for this batch
        cf = np.zeros((B, 3, max_frames), np.float32)
        for i, t in enumerate(tracks):
            n = min(t.shape[1], max_frames)
            cf[i, :, :n] = t[:, :n]
        out_extra["cached_f0"] = cf

    return {
        **out_extra,
        "audio": audio,
        "audio_lengths": audio_lens,
        "text": text,
        "input_lengths": text_lens,
        "speaker_ids": np.array([x["speaker_id"] for x in items], np.int32),
        "accent_ids": np.array([x["accent_id"] for x in items], np.int32),
        "speaker_f0_mean": np.array(
            [x["speaker_f0_mean"] for x in items], np.float32),
        "speaker_f0_std": np.array(
            [x["speaker_f0_std"] for x in items], np.float32),
        "speaker_energy_mean": np.array(
            [x["speaker_energy_mean"] for x in items], np.float32),
        "speaker_energy_std": np.array(
            [x["speaker_energy_std"] for x in items], np.float32),
        "audiopaths": [x["audiopath"] for x in items],
        "text_raw": [x["text_raw"] for x in items],
        "language": [x["language"] for x in items],
        "idx": np.array([x["idx"] for x in items], np.int32),
    }


def _key(*entropy: int) -> int:
    """A 64-bit generator seed from non-negative integers."""
    return int(np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0])


class Featurizer:
    """Batched feature extraction on the device -> a training-step batch.
    Runs on ``device`` (the card unless the caller asks for the CPU);
    ``featurize_raw`` runs on the device of its inputs. A call on the card
    replays its CUDA graphs in ``pool`` (``OWN_POOL``: a new pool; None:
    eager; see the module docstring)."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, f0_min=80.0, f0_max=640.0,
                 use_log_f0=True, use_scaled_energy=True,
                 use_attn_prior_masking=True,
                 betabinom_scaling_factor=0.05,
                 mel_noise_scale=0.0, distance_tx_unvoiced=False,
                 f0_method="pyin", seed=0, device="cuda",
                 pool: Union[GraphPool, str, None] = OWN_POOL):
        self.device = resolve_device(device)
        self.mel = MelSpectrogram(filter_length, hop_length, win_length,
                                  n_mel_channels, sampling_rate, mel_fmin,
                                  mel_fmax)
        self.hop_length = hop_length
        self.filter_length = filter_length
        self.sampling_rate = sampling_rate
        self.f0_min, self.f0_max = f0_min, f0_max
        self.use_log_f0 = use_log_f0
        self.use_scaled_energy = use_scaled_energy
        self.use_attn_prior_masking = use_attn_prior_masking
        self.betabinom_scaling_factor = betabinom_scaling_factor
        self.mel_noise_scale = mel_noise_scale
        self.distance_tx_unvoiced = distance_tx_unvoiced
        # 'pyin' (Viterbi-smoothed) or 'yin' (per-frame observations only)
        self.f0_method = f0_method
        self.seed = seed
        # calls since the last set_noise_base: each call's noise key folds
        # in (process index, base, count), so a resumed run does not replay
        # the sequence from 0
        self._n_calls = 0
        self._noise_base = 0
        self._lock = threading.Lock()
        self.use_pool(pool)

    def use_pool(self, pool: Union[GraphPool, str, None]) -> None:
        """Replay the calls' graphs in ``pool`` from now (``OWN_POOL``: a
        new pool; None: run them eagerly). The program holds the
        featurizer weakly: the featurizer holds the program, and a cycle
        would keep its graphs' memory until the cyclic collector ran."""
        ref = weakref.ref(self)

        def program(inputs):
            return ref().featurize_raw(inputs["raw"], None,
                                       noise=inputs.get("noise"))

        with self._lock:
            self.pool = own_pool(pool)
            self._program = graph_program(program, self.pool, "featurize")

    def set_noise_base(self, step: int):
        """Re-key the per-call mel-noise stream from a trainer step (on
        checkpoint resume) so it continues instead of replaying from 0."""
        self._noise_base = int(step)
        self._n_calls = 0

    def noise_key_for_step(self, step: int) -> int:
        """The mel-noise key of trainer step ``step``, from (seed, process
        index, step): the same data sees one noise sequence however the
        steps are grouped, and a resume at step N continues it exactly."""
        return _key(self.seed, mesh.get_mesh().data_index, int(step))

    def _next_noise_key(self) -> Optional[int]:
        if self.mel_noise_scale <= 0:
            return None
        key = _key(self.seed, mesh.get_mesh().data_index, self._noise_base,
                   self._n_calls)
        self._n_calls += 1
        return key

    def mel_noise(self, raw: Dict[str, torch.Tensor],
                  noise_key: Optional[int]) -> Optional[torch.Tensor]:
        """The mel noise ``featurize_raw(raw, noise_key)`` adds, drawn on
        ``raw``'s device from a generator seeded with ``noise_key`` (None
        when ``mel_noise_scale`` is 0). A CUDA graph of the featurizer
        takes it as an input: a fresh generator each call is host work."""
        if self.mel_noise_scale <= 0:
            return None
        audio = raw["audio_i16"]
        shape = (audio.shape[0], audio.shape[1] // self.hop_length,
                 self.mel.n_mel_channels)
        gen = torch.Generator(device=audio.device).manual_seed(noise_key)
        return torch.randn(shape, generator=gen, device=audio.device)

    def _featurize(self, audio, audio_lens, text_lens, max_text: int,
                   noise: Optional[torch.Tensor], cached_f0=None):
        hop = self.hop_length
        # drop the +1 frame so the mel frames equal the bucket multiple
        mel = self.mel(audio)[:, :audio.shape[1] // hop]
        n = mel.shape[1]
        mel_lens = torch.clamp(1 + audio_lens // hop, max=n).to(torch.int32)

        if cached_f0 is not None:
            f0, voiced, p_voiced = (cached_f0[:, i, :n] for i in range(3))
        else:
            f0_fn = pyin_f0 if self.f0_method == "pyin" else yin_f0
            f0, voiced, p_voiced = (t[:, :n] for t in f0_fn(
                audio, sampling_rate=self.sampling_rate,
                frame_length=self.filter_length, hop_length=hop,
                f0_min=self.f0_min, f0_max=self.f0_max))
        if self.use_log_f0:
            f0 = torch.where(f0 >= self.f0_min,
                             torch.log(torch.clamp_min(f0, 1.0)), 0.0)
        if self.distance_tx_unvoiced:
            # f0 -= log(distance to the nearest voiced frame), clamped at 0
            voiced_f0 = f0 > 0.0
            idx = torch.arange(n, dtype=torch.float32,
                               device=f0.device)[None, :]
            big = float(n)
            last_voiced = torch.cummax(
                torch.where(voiced_f0, idx, -big), dim=1).values
            next_voiced = -torch.cummax(
                torch.where(voiced_f0, -idx, -2 * big).flip(1),
                dim=1).values.flip(1)
            dist = torch.clamp(torch.minimum(idx - last_voiced,
                                             next_voiced - idx), 0.0, big)
            dmap = torch.clamp_min(torch.log(torch.clamp_min(dist, 1e-6)),
                                   0.0)
            f0 = f0 - torch.where(voiced_f0, 0.0, dmap)
        if noise is not None:
            mel = mel + noise * self.mel_noise_scale

        energy = mel.mean(dim=-1)
        if self.use_scaled_energy:
            energy = (energy + 20.0) / 20.0

        frame_mask = (torch.arange(n, device=mel.device)[None, :]
                      < mel_lens[:, None]).to(mel.dtype)
        mel = mel * frame_mask[..., None]
        f0, voiced, energy = (t * frame_mask for t in (f0, voiced, energy))

        if self.use_attn_prior_masking:
            prior = beta_binomial_prior(
                text_lens, mel_lens, max_text=max_text, max_mel=n,
                scaling_factor=self.betabinom_scaling_factor)
        else:
            prior = torch.ones((audio.shape[0], n, max_text),
                               device=mel.device)
        return mel, mel_lens, f0, voiced, p_voiced, energy, prior

    def raw_arrays(self, host_batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Host collate dict -> the array inputs of ``featurize_raw``:
        strings dropped, audio quantised to int16 (wav sources are int16,
        so the /32768 round trip is exact, and the upload is 4x smaller
        than f32)."""
        raw = {k: v for k, v in host_batch.items()
               if isinstance(v, np.ndarray) and k != "audio"}
        raw["audio_i16"] = np.clip(np.rint(host_batch["audio"] * 32768.0),
                                   -32768, 32767).astype(np.int16)
        return raw

    def featurize_raw(self, raw: Dict[str, torch.Tensor],
                      noise_key: Optional[int],
                      noise: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """``raw_arrays`` as tensors on one device -> the training-step
        batch on that device. ``noise_key`` seeds the mel noise (unused
        when ``mel_noise_scale`` is 0), unless ``noise``, drawn by
        ``mel_noise``, is given."""
        if noise is None:
            noise = self.mel_noise(raw, noise_key)
        audio = raw["audio_i16"].to(torch.float32) / 32768.0
        mel, mel_lens, f0, voiced, p_voiced, energy, prior = self._featurize(
            audio, raw["audio_lengths"], raw["input_lengths"],
            int(raw["text"].shape[1]), noise, raw.get("cached_f0"))
        batch = {k: v for k, v in raw.items()
                 if k not in ("audio_i16", "cached_f0")}
        batch["audio"] = audio
        batch.update(mel=mel, output_lengths=mel_lens, f0=f0,
                     voiced_mask=voiced, p_voiced=p_voiced,
                     energy_avg=energy, attn_prior=prior)
        return batch

    def program_inputs(self, raw: Dict[str, torch.Tensor],
                       noise_key: Optional[int]) -> Dict[str, Any]:
        """The inputs of a call's graph: the raw batch and its mel noise
        (absent where the featurizer adds none), drawn eagerly on the
        current stream, since a fresh generator each call is host work."""
        noise = self.mel_noise(raw, noise_key)
        return {"raw": raw} if noise is None else {"raw": raw, "noise": noise}

    def __call__(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host collate dict -> the full training-step batch on the
        featurizer's device, ready on the calling thread's current
        stream."""
        arrays = self.raw_arrays(host_batch)
        with self._lock:
            if self.device.type == "cuda" and self.pool is not None:
                batch = self._replayed(arrays)
            else:
                raw = {k: torch.from_numpy(v).to(self.device)
                       for k, v in arrays.items()}
                batch = self._program(
                    self.program_inputs(raw, self._next_noise_key()),
                    key=(self.f0_method,))
        for k in ("audiopaths", "text_raw", "language"):
            if k in host_batch:
                batch[k] = host_batch[k]
        return batch

    def _replayed(self, arrays: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """A call through the graphs on the pool's stream, its batch
        handed to the caller's stream."""
        caller = torch.cuda.current_stream(self.device)
        side = self.pool.open()
        with torch.cuda.stream(side):
            raw = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in arrays.items()}
            batch = self._program(
                self.program_inputs(raw, self._next_noise_key()),
                key=(self.f0_method,))
        caller.wait_stream(side)
        for t in batch.values():
            t.record_stream(caller)
        return batch


class BucketBatcher:
    """Length-bucketed batch index sampler: utterances of similar length
    share a batch so padded shapes stay few, while batch membership
    reshuffles every epoch within windows of ``bucket_window_batches``
    batches."""

    def __init__(self, lengths: Sequence[float], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 bucket_window_batches: int = 8):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.window = batch_size * max(1, bucket_window_batches)

    def __iter__(self):
        order = np.argsort(self.lengths, kind="stable")
        if self.shuffle:
            for s in range(0, len(order), self.window):
                self.rng.shuffle(order[s:s + self.window])
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            self.rng.shuffle(batches)
        for b in batches:
            yield list(map(int, b))

    def __len__(self):
        return (len(self.lengths) + self.batch_size - 1) // self.batch_size
