"""Datasets: filelist parsing and the host side of each utterance.

Counterpart of ``radmmm_tpu/data/dataset.py``. The host loads the wav,
encodes the text, looks up the ids and applies the sampled wave
augmentation (``data/wave_transforms.py``, on CPU tensors in the loader's
threads); the DSP that makes the features runs batched on the card
(``data/collate.Featurizer``).

The reference's dataset dict format (basedir / sampling_rate / filelist /
language / phonemized), pipe-separated filelists
``path|text|speaker|emotion|duration``, speaker and accent id tables sorted
and unique over the training set, the speaker / emotion / duration filters
and the speaker-stats JSON. An optional mmap'd audio cache
(``audio_cache_path``, the LMDB store of the reference, data.py:264-269)
replaces the wav reads, and an optional F0 cache (``f0_cache_path``,
``data/f0_cache.py``) gives each item its precomputed track, transformed
for the item's augmentation, so the featurizer skips pYIN; both are
``native.FeatureCache`` files, written by
``radmmm_torch.scripts.build_audio_cache`` and ``build_f0_cache`` (or by
the JAX package's scripts: the format is shared).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
from scipy.io import wavfile

from radmmm_torch.data.f0_cache import f0_key, transform_cached_f0
from radmmm_torch.data.wave_transforms import WaveAugmentations
from radmmm_torch.native import FeatureCache


@dataclasses.dataclass
class Utterance:
    audiopath: str
    text: str
    speaker: str
    emotion: str
    duration: float
    language: str
    phonemized: bool


def load_filelists(datasets: Dict[str, Dict[str, Any]],
                   multilingual: bool = True,
                   combine_speaker_and_emotion: bool = False,
                   split: str = "|") -> List[Utterance]:
    """Parse the reference's dataset dict format (data.py:246-286)."""
    out: List[Utterance] = []
    for name, d in datasets.items():
        if d is None:  # overlay configs remove a corpus by nulling its key
            continue
        base = os.path.join(d["basedir"], str(d.get("sampling_rate", "")))
        filelist = os.path.join(d.get("filelist_basedir", ""), d["filelist"])
        language = d.get("language", "en_US") if multilingual else "en_US"
        phonemized = bool(d.get("phonemized", False))
        with open(filelist, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(split)
                if len(parts) < 5:
                    continue
                speaker = (parts[2] + "-" + parts[3]
                           if combine_speaker_and_emotion else parts[2])
                out.append(Utterance(
                    audiopath=os.path.join(base, parts[0]), text=parts[1],
                    speaker=speaker, emotion=parts[3],
                    duration=float(parts[4]), language=language,
                    phonemized=phonemized))
    return out


def attribute_id_table(data: List[Utterance],
                       attribute: str = "speaker") -> Dict[str, int]:
    """Sorted-unique -> contiguous ids (data.py:307-312)."""
    values = sorted({getattr(x, attribute) for x in data})
    return {v: i for i, v in enumerate(values)}


def load_speaker_stats(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if not path:
        return None
    with open(path) as f:
        stats = json.load(f)
    return {k.lower(): v for k, v in stats.items()}


def load_wav(path: str):
    """-> (float32 array scaled to [-1, 1]-ish raw ints, sampling_rate)."""
    sr, data = wavfile.read(path)
    return np.asarray(data).astype(np.float32), sr


class AudioDataset:
    """Host-side dataset: items carry raw audio + encoded text + ids.

    Feature extraction happens later in `featurize_batch` (collate.py).
    """

    def __init__(self, datasets: Dict[str, Any], tp,
                 dataloader_type: str = "train",
                 sampling_rate: int = 22050, max_wav_value: float = 32768.0,
                 speaker_ids: Optional[Dict[str, int]] = None,
                 accent_ids: Optional[Dict[str, int]] = None,
                 include_speakers=None, include_emotions=None,
                 dur_min: Optional[float] = None,
                 dur_max: Optional[float] = None,
                 use_multilingual_model: bool = True,
                 combine_speaker_and_emotion: bool = False,
                 use_wave_augmentations: bool = False,
                 wave_aug_config: Optional[Dict[str, Any]] = None,
                 speaker_stats_path: Optional[str] = None,
                 f0_pred_type: str = "norm_log_f0",
                 speaker_map=None, accent_map=None,
                 audio_cache_path: Optional[str] = None,
                 f0_cache_path: Optional[str] = None,
                 seed: int = 1234):
        self.tp = tp
        self.dataloader_type = dataloader_type
        self.sampling_rate = sampling_rate
        self.max_wav_value = max_wav_value
        self.f0_pred_type = f0_pred_type
        self.speaker_map = speaker_map
        self.accent_map = accent_map
        self.rng = np.random.default_rng(seed)

        self.data = load_filelists(datasets, use_multilingual_model,
                                   combine_speaker_and_emotion)
        self.speaker_ids = (speaker_ids if speaker_ids
                            else attribute_id_table(self.data, "speaker"))
        self.accent_ids = (accent_ids if accent_ids
                           else attribute_id_table(self.data, "language"))

        if include_speakers:
            for speaker_set, include in include_speakers:
                self.data = [x for x in self.data
                             if (x.speaker in speaker_set) == bool(include)]
        if include_emotions:
            for emotion_set, include in include_emotions:
                emos = {e.lower() for e in emotion_set}
                self.data = [x for x in self.data
                             if (x.emotion.lower() in emos) == bool(include)]
        if dur_min is not None and dur_max is not None:
            self.data = [x for x in self.data
                         if dur_min <= x.duration <= dur_max]

        # the audio, keyed by audiopath, in place of the wav files
        self.audio_cache = (FeatureCache(audio_cache_path)
                            if audio_cache_path else None)
        # (3, F) [f0, voiced, p_voiced] tracks keyed f0::<audiopath>
        self.f0_cache = FeatureCache(f0_cache_path) if f0_cache_path else None

        self.n_base_speakers = len(self.speaker_ids)
        self.augmentations = None
        if use_wave_augmentations:
            self.augmentations = WaveAugmentations.from_config(
                wave_aug_config)
        self.speaker_stats = load_speaker_stats(speaker_stats_path)

    def encoded_text_length(self, index: int) -> int:
        """Token count of item ``index``'s encoded text, without touching
        audio. The loader's shape runs schedule padded shapes from it
        (encode_text is deterministic, so this matches __getitem__)."""
        item = self.data[index]
        return len(self.tp.encode_text(item.text, language=item.language,
                                       is_phonemized=item.phonemized))

    def __len__(self):
        return len(self.data)

    def _stats_for(self, speaker: str):
        f0_mean = f0_std = energy_mean = energy_std = 0.0
        if self.speaker_stats is not None:
            s = self.speaker_stats.get(speaker.lower())
            assert s is not None, f"missing speaker stats for {speaker}"
            if self.f0_pred_type == "norm_log_f0":
                f0_mean, f0_std = s["log_f0_mean"], s["log_f0_std"]
            else:
                f0_mean, f0_std = s["f0_mean"], s["f0_std"]
            energy_mean, energy_std = s["energy_mean"], s["energy_std"]
        return f0_mean, f0_std, energy_mean, energy_std

    def __getitem__(self, index: int) -> Optional[Dict[str, Any]]:
        item = self.data[index]
        try:
            if self.audio_cache is not None:
                cached = self.audio_cache.get_array(item.audiopath)
                if cached is None:
                    raise KeyError(f"{item.audiopath} not in audio cache")
                audio, sr = cached.astype(np.float32), self.sampling_rate
            else:
                audio, sr = load_wav(item.audiopath)
        except Exception as e:  # broken audio -> dropped by collate
            print(f"wav loading failed for {item.audiopath}: {e}")
            return None
        if sr != self.sampling_rate:
            raise ValueError(
                f"{sr} SR doesn't match target {self.sampling_rate} SR")
        audio = audio / self.max_wav_value

        speaker = item.speaker
        if self.speaker_map and speaker in self.speaker_map:
            speaker = self.speaker_map[speaker]
        speaker_id = self.speaker_ids[speaker]
        language = item.language
        if self.accent_map and language in self.accent_map:
            language = self.accent_map[language]
        accent_id = self.accent_ids[language]

        aug_factors = {}
        if self.augmentations is not None:
            apply, aug_index, aug_factors = self.augmentations.sample(
                self.rng, language=item.language)
            if apply:
                audio = self.augmentations.apply(audio, aug_factors)
                speaker_id = self.augmentations.remap_speaker_id(
                    speaker_id, aug_index, self.n_base_speakers)

        text_encoded = np.asarray(self.tp.encode_text(
            item.text, language=item.language,
            is_phonemized=item.phonemized), np.int32)

        cached_f0 = None
        if self.f0_cache is not None:
            track = self.f0_cache.get_array(f0_key(item.audiopath))
            if track is not None:
                cached_f0 = transform_cached_f0(track, aug_factors)

        f0_mean, f0_std, energy_mean, energy_std = self._stats_for(
            item.speaker)
        return {
            "audio": audio.astype(np.float32),
            "cached_f0": cached_f0,
            "text_encoded": text_encoded,
            "speaker_id": speaker_id,
            "accent_id": accent_id,
            "audiopath": item.audiopath,
            "text_raw": item.text,
            "language": item.language,
            "idx": index,
            "speaker_f0_mean": f0_mean,
            "speaker_f0_std": f0_std,
            "speaker_energy_mean": energy_mean,
            "speaker_energy_std": energy_std,
        }


class TextOnlyData:
    """Inference dataset from a JSON transcript (data.py:793-915):
    per-item script/speaker/language with optional per-attribute speaker-id
    overrides (decoder/duration/f0/energy)."""

    OVERRIDE_KEYS = ("decoder_spk_id", "duration_spk_id", "f0_spk_id",
                     "energy_spk_id")

    def __init__(self, transcript_path: Optional[str], tp,
                 speaker_id_map: Dict[str, int],
                 accent_id_map: Dict[str, int],
                 combine_speaker_and_emotion: bool = False,
                 speaker_stats_path: Optional[str] = None,
                 f0_pred_type: Optional[str] = None):
        self.data = []
        if transcript_path:
            with open(transcript_path, encoding="utf-8") as f:
                self.data = json.load(f)
        self.tp = tp
        self.speaker_id_map = speaker_id_map
        self.accent_id_map = accent_id_map
        self.combine = combine_speaker_and_emotion
        self.f0_pred_type = f0_pred_type
        self.speaker_stats = load_speaker_stats(speaker_stats_path)

    def __len__(self):
        return len(self.data)

    def _speaker_name(self, elts, key="spk_id"):
        return (elts[key] + "-" + elts["emotion"] if self.combine
                else elts[key])

    def __getitem__(self, index: int) -> Dict[str, Any]:
        elts = self.data[index]
        script = elts["script"]
        language = elts.get("language")
        name = self._speaker_name(elts)
        spk_id = self.speaker_id_map[name]
        accent_id = self.accent_id_map[language]
        text_encoded = np.asarray(self.tp.encode_text(
            script, language=language, is_phonemized=False), np.int32)

        f0_mean = f0_std = 0.0
        if self.speaker_stats is not None:
            s = self.speaker_stats.get(name.lower())
            if s is not None:
                if self.f0_pred_type == "norm_log_f0":
                    f0_mean, f0_std = s["log_f0_mean"], s["log_f0_std"]
                else:
                    f0_mean, f0_std = s["f0_mean"], s["f0_std"]

        out = {"script": script, "spk_id": spk_id,
               "decoder_spk_id": spk_id, "duration_spk_id": spk_id,
               "f0_spk_id": spk_id, "energy_spk_id": spk_id,
               "accent_id": accent_id, "text_encoded": text_encoded,
               "idx": index, "speaker_f0_mean": f0_mean,
               "speaker_f0_std": f0_std, "language": language}
        for key in self.OVERRIDE_KEYS:
            if key in elts:
                out[key] = self.speaker_id_map[
                    self._speaker_name(elts, key)]
        return out
