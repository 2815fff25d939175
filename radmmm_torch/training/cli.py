"""CLI: ``python -m radmmm_torch.training.cli fit|predict|export|vocoder-fit
-c cfg.yaml [-c more.yaml ...] [--dotted.key=value ...] [--ckpt_path P]
[--device cuda|cpu] [--distributed [--dist-backend nccl|gloo]]``.

Counterpart of ``radmmm_tpu/training/cli.py`` (the reference's
tts_main.py:36-68, RADTTSLightningCLI): several configs merged in order,
the reference's ``model:`` / ``data:`` / ``trainer:`` sections
(class_path / init_args) and dotted overrides. The data -> model links
(tts_main.py:48-61) follow the translation: sampling rate, symbol set and
text-frontend flags flow from the data section, and n_text_tokens comes
from the symbol table. ``vocoder-fit`` trains a vocoder on the data
section's corpus (``training/vocoder_loop.py``). ``--device`` defaults to
the card and fails without one unless ``cpu`` is asked for.

``--distributed`` joins the process group torchrun sets up, one process a
card (``parallel.mesh.init_distributed``; NCCL on the cards, gloo on the
CPU or, with ``--dist-backend gloo``, ranks sharing a card):

    torchrun --nproc-per-node N -m radmmm_torch.training.cli fit \
        --distributed -c ...

``trainer.devices`` (or ``trainer.n_data``) and ``trainer.n_model`` must
multiply to the number of processes; each process loads its own batch of
``batchsize``. ``predict`` and ``export`` run on rank 0 while the others
wait; ``vocoder-fit`` trains in one process.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List

import torch

from radmmm_torch.data.module import AudioDataModule
from radmmm_torch.models.tts import TTSConfig
from radmmm_torch.parallel.mesh import init_distributed
from radmmm_torch.training.loop import Trainer, TrainerConfig
from radmmm_torch.training.step import LossConfig
from radmmm_torch.utils.config import (apply_overrides, load_configs,
                                       translate_reference_data_config,
                                       translate_reference_model_config)
from radmmm_torch.utils.device import resolve_device


def build_all(cfg: dict, device: str = "cuda"):
    translated = translate_reference_model_config(cfg)
    data_kwargs = translate_reference_data_config(cfg)

    dm = AudioDataModule(**data_kwargs, device=device)

    tts_kwargs = translated["tts"]
    # data -> model links (tts_main.py:48-61)
    tts_kwargs["n_text_tokens"] = dm.n_text_tokens
    tts_cfg = TTSConfig(**tts_kwargs)

    loss_cfg = LossConfig(**translated["loss"])

    trainer_section = cfg.get("trainer", {})
    run = translated["run"]
    # the reference's `trainer.devices` (DDP GPU count) is the data axis
    devices = trainer_section.get("devices")
    n_data = trainer_section.get(
        "n_data", devices if isinstance(devices, int) else None)
    kwargs = dict(
        n_data=n_data,
        n_model=trainer_section.get("n_model", 1),
        griffin_lim_iters=trainer_section.get("griffin_lim_iters", 30),
        output_directory=run["output_directory"],
        max_steps=trainer_section.get("max_steps", 1_000_000),
        max_epochs=trainer_section.get("max_epochs", 10_000),
        val_interval=trainer_section.get("val_check_interval", 500),
        iters_per_checkpoint=run["iters_per_checkpoint"],
        seed=run["seed"],
        learning_rate=translated["optim"]["learning_rate"],
        weight_decay=translated["optim"]["weight_decay"],
        optim_algo=translated["optim"]["optim_algo"],
        grad_clip_val=translated["optim"]["grad_clip_val"],
        use_syncbnorm=run["use_syncbnorm"],
        decoder_path=run["decoder_path"],
        encoders_path=run["encoders_path"],
        vocoder_type=run.get("vocoder_type", "hifigan"),
        vocoder_config_path=run["vocoder_config_path"],
        vocoder_checkpoint_path=run["vocoder_checkpoint_path"],
        sampling_rate=data_kwargs["featurizer_kwargs"]["sampling_rate"],
        hop_length=data_kwargs["featurizer_kwargs"]["hop_length"],
        conv_precision=cfg.get("model", {}).get("conv_precision", "f32"),
        prediction_output_dir=run["prediction_output_dir"],
        predict_mode=run["predict_mode"],
        device=device,
    )
    # any trainer key naming a TrainerConfig field passes through, and
    # wins over the values translated from the model and data sections
    field_names = {f.name for f in dataclasses.fields(TrainerConfig)}
    kwargs.update({k: v for k, v in trainer_section.items()
                   if k in field_names})
    trainer_cfg = TrainerConfig(**kwargs)
    return dm, Trainer(tts_cfg, loss_cfg, trainer_cfg)


def main(argv: List[str] = None):
    """Run one subcommand; returns the data module and the trainer it
    used (a vocoder trainer for ``vocoder-fit``)."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog="radmmm_torch.training.cli")
    parser.add_argument("subcommand",
                        choices=["fit", "predict", "vocoder-fit", "export"])
    parser.add_argument("-c", "--config", action="append", default=[],
                        help="YAML config (repeatable; later overrides)")
    parser.add_argument("--ckpt_path", default=None,
                        help="checkpoint to restore: an integer step of "
                             "this run, another run's directory, a ckpt "
                             "dir, or a step dir like <run>/ckpt/9000")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--distributed", action="store_true",
                        help="one process a card under torchrun")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"],
                        default=None,
                        help="with --distributed: nccl (the default on the "
                             "card, one card a rank) or gloo")
    args, unknown = parser.parse_known_args(argv)

    if args.distributed:
        if args.subcommand == "vocoder-fit":
            parser.error("vocoder-fit trains in one process; drop "
                         "--distributed")
        device = str(init_distributed(args.device, args.dist_backend))
    else:
        device = str(resolve_device(args.device))

    cfg = load_configs(args.config)
    cfg = apply_overrides(cfg, [u for u in unknown if "=" in u])

    if args.subcommand == "vocoder-fit":
        from radmmm_torch.training.vocoder_loop import vocoder_fit
        dm = AudioDataModule(**translate_reference_data_config(cfg),
                             device=device)
        return dm, vocoder_fit(cfg, dm, device=device)

    if args.distributed and args.subcommand != "fit" \
            and torch.distributed.get_rank() != 0:
        # predict and export run on rank 0, with the full model
        torch.distributed.barrier()
        return None, None
    dm, trainer = build_all(cfg, device=device)
    if args.ckpt_path is not None:
        trainer.cfg.ckpt_path = args.ckpt_path
    if args.subcommand == "fit":
        trainer.fit(dm)
    elif args.subcommand == "export":
        ex = cfg.get("export", {})
        buckets = ex.get("buckets")
        if isinstance(buckets, str):  # "--export.buckets=8x96,4x48,1x32"
            buckets = [tuple(int(d) for d in b.split("x"))
                       for b in buckets.split(",") if b]
        elif buckets:
            buckets = [tuple(int(d) for d in b) for b in buckets]
        frame_buckets = ex.get("frame_buckets")
        if isinstance(frame_buckets, str):  # "--export.frame_buckets=192,800"
            frame_buckets = [int(f) for f in frame_buckets.split(",") if f]
        trainer.export(
            ex.get("path", os.path.join(trainer.cfg.output_directory,
                                        "tts_export.bin")),
            batch_size=ex.get("batch_size", 8),
            max_text=ex.get("max_text", 96),
            use_vocoder=ex.get("use_vocoder", True),
            buckets=buckets, frame_buckets=frame_buckets)
    else:
        trainer.predict(dm)
    if args.distributed and args.subcommand != "fit":
        torch.distributed.barrier()
    return dm, trainer


if __name__ == "__main__":
    main()
