"""Dataset recipe JSONs -> runnable data configs.

The reference ships its training recipes as data: per-corpus JSON files
(`datasets/22khz-ljs.json`, `datasets/22khz-limmits-*.json`) whose entries
name the audio checkout, filelists, and language
(the reference's datasets/22khz-ljs.json), plus per-speaker prosody stats
(`datasets/speaker_stats/*.json`). This module makes those recipes
first-class inputs: `recipe_dataset_configs` expands a recipe JSON into the
`training_files`/`validation_files` dataset dicts the data pipeline
consumes (the translation layer accepts `data.dataset_recipe:` directly),
and `collate_speaker_stats` merges the reference's per-speaker
`<Speaker>-other.json` stats files into the collated speaker->stats map the
dataset expects (`data/dataset.py:load_speaker_stats`).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

REQUIRED_KEYS = ("basedir", "filelist", "language")


def load_recipe(path: str) -> Dict[str, Dict[str, Any]]:
    """Parse + validate a recipe JSON ({corpus_key: entry})."""
    with open(path, encoding="utf-8") as f:
        recipe = json.load(f)
    if not isinstance(recipe, dict) or not recipe:
        raise ValueError(f"recipe {path} is not a non-empty JSON object")
    for key, entry in recipe.items():
        missing = [k for k in REQUIRED_KEYS if k not in entry]
        if missing:
            raise ValueError(
                f"recipe {path} entry {key!r} is missing {missing}")
    return recipe


def recipe_dataset_configs(recipe_path: str, split: str = "train",
                           audio_root: Optional[str] = None,
                           filelist_basedir: str = "datasets/"
                           ) -> Dict[str, Dict[str, Any]]:
    """Recipe JSON -> {corpus: dataset dict} for `load_filelists`.

    split: 'train' | 'val' | 'all' picks `train_filelist` / `val_filelist`
    / `filelist` (falling back to `filelist` when a split-specific list is
    absent). `audio_root` overrides the recipe's absolute `basedir` (the
    reference records cluster paths): the corpus `basedir` becomes
    `<audio_root>/<basename(basedir)>`.
    """
    recipe = load_recipe(recipe_path)
    key = {"train": "train_filelist", "val": "val_filelist",
           "all": "filelist"}[split]
    out: Dict[str, Dict[str, Any]] = {}
    for corpus, entry in recipe.items():
        basedir = entry["basedir"].rstrip("/")
        if audio_root is not None:
            basedir = os.path.join(audio_root, os.path.basename(basedir))
        out[corpus] = {
            "basedir": basedir,
            # the recipe's audio_dir plays the data config's sampling_rate
            # subdirectory role (reference joins basedir/<sampling_rate>)
            "sampling_rate": entry.get("audio_dir", ""),
            "filelist_basedir": filelist_basedir,
            "filelist": entry.get(key) or entry["filelist"],
            "language": entry["language"],
            "lmdbpath": entry.get("lmdbpath", ""),
        }
    return out


def collate_speaker_stats(stats_dir: str,
                          out_path: Optional[str] = None
                          ) -> Dict[str, Dict[str, float]]:
    """Merge per-speaker `<Speaker>-<emotion>.json` stats files into one
    collated {speaker: stats} map (the `speaker_stats_path` format).

    The reference ships LIMMITS stats as single-speaker files
    (datasets/speaker_stats/Hindi_F-other.json ...); the dataset wants the
    collated form (datasets/speaker_stats/opensource_collated_stats.json).
    Keys are the file stems (e.g. 'Hindi_F-other'), which match the
    speaker column when `combine_speaker_and_emotion` is on.
    """
    collated: Dict[str, Dict[str, float]] = {}
    for path in sorted(glob.glob(os.path.join(stats_dir, "*.json"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            stats = json.load(f)
        if "f0_mean" in stats:          # a single-speaker stats file
            collated[stem] = stats
    if out_path:
        with open(out_path, "w") as f:
            json.dump(collated, f, indent=1)
    return collated
