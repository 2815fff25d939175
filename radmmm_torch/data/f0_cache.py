"""Per-utterance F0 cache: pYIN precomputed on the card, stored on the host.

Counterpart of ``radmmm_tpu/data/f0_cache.py``. The reference disk-caches
librosa.pyin per utterance because it is slow (data.py:491-527, ``*.pt``
files next to the wavs). Here one pass over the corpus runs the port's
batched pYIN (``data/pitch.py``) on the card over length-sorted batches
and writes each utterance's (3, n_frames) float32 track
[f0_hz, voiced, p_voiced] into the mmap'd ``native.FeatureCache`` under
``f0::<audiopath>``, as the JAX package does: either package reads the
other's cache.

The JAX package jits pYIN; here it runs through
``utils/graphs.Graphed`` in a pool of its own: the batches are
length-sorted and padded to a multiple of ``frames_multiple`` frames, so
their shapes repeat, and a shape's second batch is captured and its later
ones replay (a shape seen once stays an eager warm-up). The tracks are
read back to the host outside the graph.

Training then skips pYIN for batches whose items all have a track
(``data/collate.py``). Augmented items transform the cached track
analytically: pitch scaling multiplies F0, duration scaling resamples the
frame axis, formant shifting leaves F0 alone (``data/dataset.py``).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Union

import numpy as np
import torch

from radmmm_torch.data.collate import round_up
from radmmm_torch.data.pitch import pyin_f0, yin_f0
from radmmm_torch.native import FeatureCacheWriter
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import OWN_POOL, GraphPool, graph_program


# each batch's frames padded to a multiple of this by default, as the JAX
# package pads them (the Viterbi's horizon, so the tracks match its cache)
FRAMES_MULTIPLE = 64


def f0_key(audiopath: str) -> str:
    return f"f0::{audiopath}"


def build_f0_cache(datasets, out_path: str, batch_size: int = 8,
                   filter_length: int = 1024, hop_length: int = 256,
                   f0_min: float = 80.0, f0_max: float = 640.0,
                   f0_method: str = "pyin", num_threads: int = 4,
                   frames_multiple: int = FRAMES_MULTIPLE, device="cuda",
                   pool: Union[GraphPool, str, None] = OWN_POOL) -> int:
    """F0 of every utterance of ``datasets`` (one dataset or a list) into
    one cache at ``out_path``, computed on ``device`` (the card unless the
    caller asks for the CPU) over batches padded to a multiple of
    ``frames_multiple`` frames, through graphs in ``pool`` (``OWN_POOL``:
    a new pool; None: eager). The datasets must be built without
    augmentations: the cache holds the original track. A path seen before
    is skipped. Returns the number of records written."""
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    dev = resolve_device(device)
    f0_fn = pyin_f0 if f0_method == "pyin" else yin_f0

    def tracks_of(inputs):
        return f0_fn(inputs["audio"], sampling_rate=inputs["sr"],
                     frame_length=filter_length, hop_length=hop_length,
                     f0_min=f0_min, f0_max=f0_max)

    program = graph_program(tracks_of, pool, f0_method)

    n_written = 0
    seen = set()
    with FeatureCacheWriter(out_path) as writer, \
            ThreadPoolExecutor(num_threads) as pool:
        for dataset in datasets:
            if dataset.augmentations is not None:
                raise ValueError("build the F0 cache from an un-augmented "
                                 "dataset")
            sr = dataset.sampling_rate
            # length-sorted, so the batches pad little
            order = sorted(range(len(dataset.data)),
                           key=lambda i: dataset.data[i].duration)
            for s in range(0, len(order), batch_size):
                idxs = order[s:s + batch_size]
                items = [x for x in pool.map(dataset.__getitem__, idxs)
                         if x is not None and x["audiopath"] not in seen]
                if not items:
                    continue
                lens = [len(x["audio"]) for x in items]
                frames = round_up(1 + max(lens) // hop_length,
                                  frames_multiple)
                T = frames * hop_length
                audio = np.zeros((len(items), T), np.float32)
                for i, x in enumerate(items):
                    audio[i, :lens[i]] = x["audio"][:T]
                with torch.no_grad():
                    tracks = program({"audio": torch.from_numpy(audio).to(
                        dev), "sr": sr})
                f0, voiced, pvd = (t.cpu().numpy() for t in tracks)
                for i, x in enumerate(items):
                    n = min(1 + lens[i] // hop_length, f0.shape[1])
                    track = np.stack([f0[i, :n], voiced[i, :n], pvd[i, :n]])
                    writer.put_array(f0_key(x["audiopath"]),
                                     track.astype(np.float32))
                    seen.add(x["audiopath"])
                    n_written += 1
    return n_written


def transform_cached_f0(track: np.ndarray, factors: dict) -> np.ndarray:
    """A cached (3, F) [f0, voiced, p_voiced] track under the wave
    augmentation's factors (``data/wave_transforms.py``): pitch p scales
    F0 by p; duration d resamples the frame axis to round(F d) frames,
    frame i taken from round(i / d); formant shifting leaves the track
    alone."""
    out = track
    p = factors.get("pitch", 1.0)
    if abs(p - 1.0) > 1e-4:
        out = out.copy()
        out[0] = out[0] * p
    d = factors.get("duration", 1.0)
    if abs(d - 1.0) > 1e-4:
        F = out.shape[1]
        F2 = max(1, int(round(F * d)))
        src = np.clip(np.round(np.arange(F2) / d).astype(np.int64), 0, F - 1)
        out = out[:, src]
    return out
