"""Precompute every utterance's F0 (pYIN on the card) into a native cache.

    python -m radmmm_torch.scripts.build_f0_cache -c data.yaml [-c ...]
        -o cache/f0 [--batch-size 8] [--include-val | --no-include-val]
        [--frames-multiple 64] [--device cuda|cpu]

Counterpart of ``scripts/build_f0_cache.py``, the batched equivalent of
the reference's lazy librosa.pyin disk cache (data.py:491-527): the
config's datasets, built without augmentations and without an F0 cache,
go through ``data/f0_cache.build_f0_cache`` with the config's featurizer
settings (frame and hop length, F0 range, ``f0_method``), each batch
padded to a multiple of ``--frames-multiple`` frames. Training with
``--data.init_args.f0_cache_path=<output>`` then skips pYIN; augmented
items derive their track from the cached one. ``--device`` defaults to the
card and raises without one unless ``cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import os

from radmmm_torch.data.f0_cache import FRAMES_MULTIPLE, build_f0_cache
from radmmm_torch.data.module import AudioDataModule
from radmmm_torch.utils.config import (load_configs,
                                       translate_reference_data_config)


def build_f0_cache_for_config(cfg: dict, out_path: str, batch_size: int = 8,
                              include_val: bool = True,
                              device: str = "cuda",
                              frames_multiple: int = FRAMES_MULTIPLE) -> int:
    """The F0 tracks of ``cfg``'s (a merged config) training utterances,
    and with ``include_val`` its validation ones, into the cache at
    ``out_path``, each batch padded to a multiple of ``frames_multiple``
    frames. Returns the number of records written."""
    dk = translate_reference_data_config(cfg)
    # the cache holds un-augmented tracks, computed from the audio
    dk["dataset_kwargs"].update(use_wave_augmentations=False,
                                f0_cache_path=None)
    dm = AudioDataModule(**dk, device=device)
    dm.setup("fit")
    fk = dk["featurizer_kwargs"]
    datasets = [dm.trainset]
    if dm.valset is not None and include_val:
        datasets.append(dm.valset)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return build_f0_cache(
        datasets, out_path, batch_size=batch_size,
        filter_length=fk["filter_length"], hop_length=fk["hop_length"],
        f0_min=fk["f0_min"], f0_max=fk["f0_max"],
        f0_method=fk["f0_method"], frames_multiple=frames_multiple,
        device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--include-val", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also cache validation utterances "
                         "(--no-include-val for a train-only cache)")
    ap.add_argument("--frames-multiple", type=int, default=FRAMES_MULTIPLE,
                    help="pad each batch's frames to a multiple of this")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = build_f0_cache_for_config(load_configs(args.config), args.output,
                                  args.batch_size, args.include_val,
                                  args.device, args.frames_multiple)
    print(f"wrote {n} F0 records to {args.output}")
    return n


if __name__ == "__main__":
    main()
