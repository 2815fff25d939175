"""The vocoder training loop behind ``vocoder-fit``.

Counterpart of ``radmmm_tpu/training/vocoder_loop.py``:
``python -m radmmm_torch.training.cli vocoder-fit -c data.yaml -c
vocoder.yaml [--device cpu]`` trains a HiFi-GAN (or, with
``vocoder.vocoder_type: waveglow``, a WaveGlow) on the configured
dataset. Config shape:

    vocoder:
      vocoder_type: hifigan                          # or waveglow
      generator: {upsample_rates: [8,8,2,2], ...}    # HiFiGANConfig or
                                                     # WaveGlow fields
      train: {segment_size: 8192, learning_rate: 2e-4, ...}
      output_directory: ./output/vocoder
      max_steps: 1000000
      log_interval: 50
      iters_per_checkpoint: 5000
      profile_dir: null        # a torch.profiler window of
      profile_start_step: 10   # profile_n_steps steps, as the
      profile_n_steps: 2       # trainer's

Each step runs through the trainer's graphed step (``training/
vocoder_train.py``): the crops are cut on the host and uploaded, their
mels computed in the step's graph. The trainer's ``stats`` count the
steps that replayed a graph (``graphed_steps``) and the pool's
``warmups``, ``captures`` and ``replays``.

The run directory is the port's own: ``ckpt/<step>/state.pt`` (the
trainer's ``state_dict``: its modules, optimizers and step, through
``utils/checkpoint.CheckpointManager``), ``tb/metrics.jsonl`` and, for
HiFi-GAN, ``generator_config.json``, from which ``get_vocoder(<run dir>)``
rebuilds the generator. A run resumes from its latest checkpoint; as in
the JAX package, the loader and the segment generator (numpy, seed 0)
start over on a resume.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict

import numpy as np

from radmmm_torch.data.loader import DataLoader
from radmmm_torch.training.vocoder_train import (HiFiGANTrainer,
                                                 VocoderTrainConfig,
                                                 WaveGlowTrainer,
                                                 random_crops)
from radmmm_torch.utils.checkpoint import CheckpointManager
from radmmm_torch.utils.logging import TrainLogger
from radmmm_torch.utils.profiling import StepProfiler
from radmmm_torch.vocoder.hifigan import HiFiGANConfig


def vocoder_fit(cfg: Dict[str, Any], dm, device: str = "cuda"):
    """Train the configured vocoder on ``dm``'s training set; returns the
    trainer, whose ``stats`` hold the run's timings."""
    vc = cfg.get("vocoder", {})
    vocoder_type = vc.get("vocoder_type", "hifigan")
    feat = dm.featurizer
    train_cfg = VocoderTrainConfig(
        sampling_rate=feat.sampling_rate,
        filter_length=feat.filter_length,
        hop_length=feat.hop_length,
        n_mel_channels=feat.mel.n_mel_channels,
        **vc.get("train", {}))
    out_dir = vc.get("output_directory", "./output/vocoder")
    max_steps = vc.get("max_steps", 1_000_000)
    log_interval = vc.get("log_interval", 50)
    iters_per_checkpoint = vc.get("iters_per_checkpoint", 5000)

    os.makedirs(out_dir, exist_ok=True)
    logger = TrainLogger(os.path.join(out_dir, "tb"))
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))

    dm.setup("fit")
    # raw audio: the mel windows come from the trainer's mel function
    loader = DataLoader(dm.trainset, dm.batch_size, shuffle=True,
                        featurizer=None, num_threads=dm.num_threads,
                        hop_length=train_cfg.hop_length)

    if vocoder_type == "waveglow":
        trainer = WaveGlowTrainer(vc.get("generator", {}), train_cfg,
                                  sigma=vc.get("sigma", 1.0), device=device)
    else:
        gen_cfg = HiFiGANConfig.from_dict(vc.get("generator", {}))
        trainer = HiFiGANTrainer(gen_cfg, train_cfg, device=device)
        # a self-describing run dir: get_vocoder(<out_dir>) rebuilds the
        # generator from it
        with open(os.path.join(out_dir, "generator_config.json"), "w") as f:
            json.dump(dataclasses.asdict(gen_cfg), f, indent=1)
    # step_starts: each step's start; end: the last step's end, its
    # checkpoint save not included
    stats = trainer.stats = dict(step_starts=[], end=None, ckpt_save_s=0.0,
                                 ckpt_bytes=0, ckpt_saves=0, restore_s=0.0,
                                 graphed_steps=0)
    t0 = time.perf_counter()
    payload, restored = mgr.load_payload()
    if restored is not None:
        trainer.load_state_dict(payload)
        stats["restore_s"] = time.perf_counter() - t0
        print(f"resumed vocoder training from step {restored}")
    step = trainer.step
    pool = trainer.pool
    profiler = StepProfiler(vc.get("profile_dir"),
                            vc.get("profile_start_step", 10),
                            vc.get("profile_n_steps", 2), trainer.device)
    rng = np.random.default_rng(0)
    t_last = time.perf_counter()
    try:
        while step < max_steps:
            for host_batch in loader:
                stats["step_starts"].append(time.perf_counter())
                profiler.before(step)
                # the crops on the host; their mels in the step's graph
                audio = random_crops(host_batch["audio"],
                                     host_batch["audio_lengths"],
                                     train_cfg.hop_length,
                                     train_cfg.segment_size, rng,
                                     trainer.device)
                replays = pool.replays if pool is not None else 0
                metrics = trainer.train_step({"audio": audio})
                if pool is not None and pool.replays > replays:
                    stats["graphed_steps"] += 1
                profiler.after(step)
                step += 1
                if step % log_interval == 0:
                    m = {k: v.item() for k, v in metrics.items()}
                    dt = time.perf_counter() - t_last
                    m["steps_per_sec"] = log_interval / dt
                    t_last = time.perf_counter()
                    logger.scalars("vocoder", m, step)
                    extra = (f"disc={m['disc_loss']:.3f} "
                             f"mel={m['gen_mel']:.3f} "
                             if "disc_loss" in m else "")
                    print(f"vocoder step {step}: gen={m['gen_loss']:.3f} "
                          f"{extra}({m['steps_per_sec']:.2f} it/s)")
                stats["end"] = time.perf_counter()
                if step % iters_per_checkpoint == 0 or step >= max_steps:
                    t0 = time.perf_counter()
                    stats["ckpt_bytes"] = mgr.save_payload(
                        step, trainer.state_dict())
                    stats["ckpt_save_s"] += time.perf_counter() - t0
                    stats["ckpt_saves"] += 1
                if step >= max_steps:
                    break
    finally:
        profiler.stop()
    stats.update(profiler.stats)
    stats.update(warmups=pool.warmups if pool else 0,
                 captures=len(pool.captures) if pool else 0,
                 replays=pool.replays if pool else 0)
    print(f"vocoder training done at step {step}; {stats['graphed_steps']} "
          f"steps replayed a graph (warm-ups {stats['warmups']}, captures "
          f"{stats['captures']}, replays {stats['replays']})")
    return trainer
