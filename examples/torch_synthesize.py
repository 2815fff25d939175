"""Minimal inference walkthrough of the port (the reference's
inference.ipynb as a script; ``examples/synthesize.py`` is the JAX
package's): load a trained run, synthesize prompts, write wavs.

    python examples/torch_synthesize.py \
        -c configs/radmmm_train.yaml -c configs/ljs_22khz_data.yaml \
        -c configs/radmmm_model.yaml -c configs/radmmm_attributes.yaml \
        --prompts prompts.json --out out_wavs/ [--device cuda]

The run is the configs' ``output_directory`` (its latest checkpoint), or
``--ckpt_path``.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("--prompts", required=True,
                    help="JSON transcript: [{script, spk_id, emotion, "
                         "language, [decoder_spk_id, ...]}]")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sigma", type=float, default=0.8)
    ap.add_argument("--max-frames", type=int, default=1024)
    ap.add_argument("--ckpt_path", default=None,
                    help="the checkpoint to restore (as the CLI's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from radmmm_torch.training.cli import build_all
    from radmmm_torch.utils.config import load_configs
    from radmmm_torch.utils.device import resolve_device

    cfg = load_configs(args.config)
    dm, trainer = build_all(cfg, device=str(resolve_device(args.device)))
    dm.inference_transcript = args.prompts
    trainer.cfg.sigma_infer = args.sigma
    trainer.cfg.max_infer_frames = args.max_frames
    if args.ckpt_path is not None:
        trainer.cfg.ckpt_path = args.ckpt_path
    if args.out:
        trainer.cfg.prediction_output_dir = args.out
    paths = trainer.predict(dm)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
