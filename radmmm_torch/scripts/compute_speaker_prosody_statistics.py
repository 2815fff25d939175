"""Per-speaker prosody statistics (F0 and energy) over a data config's
training set, in the format ``speaker_stats_path`` reads.

    python -m radmmm_torch.scripts.compute_speaker_prosody_statistics
        -c data.yaml [-c ...] -o stats_out/ [--batch-size 16]
        [--f0-min 80] [--f0-max 660] [--overwrite] [--device cuda|cpu]

Counterpart of ``scripts/compute_speaker_prosody_statistics.py`` (the
working replacement for the reference's script of that name). Each
speaker's utterances are featurized on the card (``data/collate.
Featurizer``) with the log transform of F0 off, without augmentations and
without speaker statistics. Over voiced frames with F0 strictly inside
(f0_min, f0_max) it takes the F0's median, mean and standard deviation,
linear and log; over valid frames the energy's mean and standard
deviation. It writes ``<speaker>.json`` for each speaker and
``collated_stats.json`` with all of them. A speaker whose file exists is
read back, not recomputed, unless ``--overwrite``. ``--device`` defaults to
the card and raises without one unless ``cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from radmmm_torch.data.loader import DataLoader
from radmmm_torch.data.module import AudioDataModule
from radmmm_torch.utils.config import (load_configs,
                                       translate_reference_data_config)


class IndexBatches:
    """Fixed index batches in place of the loader's BucketBatcher."""

    def __init__(self, indices, batch_size):
        self.indices = indices
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.indices), self.batch_size):
            yield self.indices[i:i + self.batch_size]

    def __len__(self):
        return (len(self.indices) + self.batch_size - 1) // self.batch_size


def speaker_stats(f0: np.ndarray, energy: np.ndarray) -> dict:
    """The statistics of one speaker's kept F0 values (Hz) and energies."""
    log_f0 = np.log(np.maximum(f0, 1e-5))
    return {
        "f0_median": float(np.median(f0)),
        "f0_mean": float(f0.mean()),
        "f0_std": float(f0.std()),
        "log_f0_median": float(np.median(log_f0)),
        "log_f0_mean": float(log_f0.mean()),
        "log_f0_std": float(log_f0.std()),
        "energy_mean": float(energy.mean()),
        "energy_std": float(energy.std()),
    }


def compute_speaker_prosody_statistics(
        cfg: dict, output_path: str, batch_size: int = 16,
        f0_min: float = 80.0, f0_max: float = 660.0,
        overwrite: bool = False, device: str = "cuda") -> dict:
    """Write each speaker's statistics of ``cfg``'s (a merged config)
    training set under ``output_path`` and return {speaker: stats}, as
    ``collated_stats.json`` holds them."""
    dk = translate_reference_data_config(cfg)
    # statistics of linear-Hz F0, from the un-augmented audio
    dk["featurizer_kwargs"]["use_log_f0"] = False
    dk["dataset_kwargs"].update(speaker_stats_path=None,
                                use_wave_augmentations=False)
    dm = AudioDataModule(**dk, device=device)
    dm.setup("fit")

    os.makedirs(output_path, exist_ok=True)
    collated = {}
    for speaker in sorted(dm.trainset.speaker_ids):
        save_path = os.path.join(output_path, f"{speaker}.json")
        if os.path.exists(save_path) and not overwrite:
            print(f"skipping {speaker}: exists at {save_path}")
            with open(save_path) as f:
                collated[speaker] = json.load(f)
            continue
        indices = [i for i, u in enumerate(dm.trainset.data)
                   if u.speaker == speaker]
        if not indices:
            continue
        f0_all, energy_all = [], []
        loader = DataLoader(dm.trainset, batch_size, shuffle=False,
                            featurizer=dm.featurizer, num_threads=4)
        loader.batcher = IndexBatches(indices, batch_size)
        for batch in loader:
            f0 = batch["f0"].cpu().numpy()
            voiced = batch["voiced_mask"].cpu().numpy() > 0
            lens = batch["output_lengths"].cpu().numpy()
            energy = batch["energy_avg"].cpu().numpy()
            for b in range(f0.shape[0]):
                f = f0[b, :lens[b]][voiced[b, :lens[b]]]
                f0_all.append(f[(f > f0_min) & (f < f0_max)])
                energy_all.append(energy[b, :lens[b]])
        f0_cat = np.concatenate(f0_all) if f0_all else np.zeros(1)
        en_cat = np.concatenate(energy_all) if energy_all else np.zeros(1)
        stats = speaker_stats(f0_cat, en_cat)
        with open(save_path, "w") as f:
            json.dump(stats, f, indent=2)
        collated[speaker] = stats
        print(f"{speaker}: {stats}")

    with open(os.path.join(output_path, "collated_stats.json"), "w") as f:
        json.dump(collated, f, indent=2)
    print(f"wrote {len(collated)} speakers to {output_path}")
    return collated


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("-o", "--output-path", required=True)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--f0-min", type=float, default=80.0)
    ap.add_argument("--f0-max", type=float, default=660.0)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return compute_speaker_prosody_statistics(
        load_configs(args.config), args.output_path, args.batch_size,
        args.f0_min, args.f0_max, args.overwrite, args.device)


if __name__ == "__main__":
    main()
