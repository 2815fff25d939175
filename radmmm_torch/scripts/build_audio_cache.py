"""Build an mmap'd audio cache for a data config's filelists.

    python -m radmmm_torch.scripts.build_audio_cache -c data.yaml [-c ...]
        -o cache/audio [--device cuda|cpu]

Counterpart of ``scripts/build_audio_cache.py``, the native replacement
for the reference's LMDB audio store: every wav of the config's training
and validation filelists becomes one record, keyed by its audiopath, of
its samples as float32 (the file's integer scale) in a
``native.FeatureCache`` at ``<output>.dat`` / ``.idx``. Training then reads
it with ``--data.init_args.lmdb_cache_path=<output>``. The cache is the
JAX package's format: either package reads the other's. Nothing here runs
on the card; ``--device`` is checked as every entry point checks it (the
card unless the CPU is asked for).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from radmmm_torch.data.dataset import load_filelists, load_wav
from radmmm_torch.native import FeatureCacheWriter
from radmmm_torch.utils.config import (load_configs,
                                       translate_reference_data_config)
from radmmm_torch.utils.device import resolve_device


def build_audio_cache(cfg: dict, out_path: str) -> tuple:
    """The audio of ``cfg``'s (a merged config) training and validation
    utterances into the cache at ``out_path``. Unreadable wavs are skipped
    and named. Returns (records written, utterances listed)."""
    dk = translate_reference_data_config(cfg)
    multilingual = dk["dataset_kwargs"]["use_multilingual_model"]
    utts = load_filelists(dk["train_config"], multilingual)
    if dk.get("val_config"):
        utts += load_filelists(dk["val_config"], multilingual)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n_ok = 0
    with FeatureCacheWriter(out_path) as w:
        for u in utts:
            try:
                audio, _ = load_wav(u.audiopath)
            except (OSError, ValueError) as e:
                print(f"skipping {u.audiopath}: {e}")
                continue
            w.put_array(u.audiopath, audio.astype(np.float32))
            n_ok += 1
    return n_ok, len(utts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n_ok, n = build_audio_cache(load_configs(args.config), args.output)
    print(f"cached {n_ok}/{n} utterances to {args.output}.dat")
    return n_ok


if __name__ == "__main__":
    main()
