"""Does the formant-scaling augmentation disentangle accent from speaker?
The port's run of the JAX package's experiment
(``scripts/aug_disentangle_experiment.py``, whose results are in
``examples/aug_experiment/``).

The reference's augmentation exists to decouple accent from speaker
identity (reference wave_transforms.py:34-79 "Change speaker",
tts_lightning_modules.py:127-136 augmented-speaker expansion). The
experiment measures that on the synthetic 4-speaker x 2-accent corpus
(``scripts/make_demo_corpus.py --accents``), where each speaker is
recorded only in its native accent in training while the generator also
renders the held-out cross combinations with their ground truth:

1. train twice through the port's CLI (``radmmm_torch.training.cli
   fit``, on the card the graphed megastep), identical configs but for
   the augmentation overlay (``aug.yaml``: none/0.9/1.1 scale_formant,
   the opensource recipe's settings) and its speaker-table expansion;
2. evaluate both checkpoints on the held-out cross-accent utterances: the
   decoder flow NLL through ``make_val_step`` and the analysis-synthesis
   mel-L1 of ``TTSModel.reconstruct`` (ground-truth attributes, the
   unseen speaker-accent pairs, its latent from a generator of seed 0);
3. report the speaker-accent embedding cross-covariance (the quantity the
   reference regularizes, loss.py:252-347; the regularizer is off here, so
   any difference is the augmentation's).

Writes ``examples/torch_aug_experiment/{REPORT.md,metrics.json}``, the
card's name and power limit beside the times, each row beside the JAX
package's run.

    python -m radmmm_torch.scripts.aug_disentangle_experiment \
        [--steps 1200] [--workdir output/aug_exp] \
        [--outdir examples/torch_aug_experiment] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_METRICS = os.path.join(ROOT, "examples", "aug_experiment",
                           "metrics.json")


def cross_cov(spk_table: np.ndarray, acc_table: np.ndarray,
              spk_accent: list) -> float:
    """Frobenius norm of the cross-covariance between per-speaker
    embeddings and their (native) accent embeddings, normalized per
    element: the statistic AttributeMinCrossCovarianceRegLoss penalizes
    (losses/regularizers.py; reference loss.py:310-347)."""
    X = spk_table[: len(spk_accent)]
    Y = acc_table[np.asarray(spk_accent)]
    Xc = X - X.mean(0, keepdims=True)
    Yc = Y - Y.mean(0, keepdims=True)
    C = Xc.T @ Yc / max(1, X.shape[0] - 1)
    return float(np.sqrt((C ** 2).mean()))


def recon_l1(mel_rec: np.ndarray, mel_gt: np.ndarray,
             lens: np.ndarray) -> List[float]:
    """Each utterance's mean absolute mel error over its frames."""
    return [float(np.abs(mel_rec[i, :int(L)] - mel_gt[i, :int(L)]).mean())
            for i, L in enumerate(lens)]


def evaluate_model(model, val_step, state, batches, spk_accent: list,
                   sigma: float = 1.0) -> Dict[str, float]:
    """The cross split's statistics of one trained state: the flow NLL
    (each batch's ``loss_mel``, averaged), the reconstruction mel-L1 (each
    utterance's, averaged; the latent from a generator of seed 0 on the
    model's device), the number of utterances and the embeddings'
    cross-covariance."""
    dev = next(model.parameters()).device
    nll, l1 = [], []
    for batch in batches:
        nll.append(val_step(state, batch)["loss_mel"].item())
        with torch.no_grad():
            rec = model.reconstruct(
                batch, sigma=sigma,
                generator=torch.Generator(device=dev).manual_seed(0))
        l1 += recon_l1(rec["mel"].cpu().numpy(), batch["mel"].cpu().numpy(),
                       batch["output_lengths"].cpu().numpy())
    spk = model.speaker_embeddings.weight.detach().cpu().numpy()
    acc = model.accent_embeddings.weight.detach().cpu().numpy()
    return {"cross_nll": float(np.mean(nll)),
            "cross_recon_mel_l1": float(np.mean(l1)),
            "n_cross_utts": len(l1),
            "emb_cross_cov": cross_cov(spk, acc, spk_accent)}


def evaluate(configs: List[str], run_dir: str, cross_yaml: str,
             device: str) -> Dict[str, float]:
    """Restore the run's checkpoint and measure it on the held-out
    cross-accent split."""
    from radmmm_torch.training.cli import build_all
    from radmmm_torch.training.step import make_val_step
    from radmmm_torch.utils.config import load_configs

    cfg = load_configs(configs + [cross_yaml])
    cfg["model"]["output_directory"] = run_dir
    dm, trainer = build_all(cfg, device=device)
    dm.setup("fit")
    batches = list(dm.val_dataloader())
    state = trainer._init_state(batches[0])
    state, step = trainer._restore_state(state, require=True)
    ids = dm.trainset.accent_ids
    # native accents of spk_a..spk_d (make_demo_corpus.ACCENT_SPEAKERS)
    spk_accent = [ids["en_US"], ids["en_US"], ids["en_UK"], ids["en_UK"]]
    out = {"ckpt_step": int(step)}
    out.update(evaluate_model(trainer.model,
                              make_val_step(trainer.model, trainer.loss_cfg),
                              state, batches, spk_accent))
    return out


def _jax_results() -> dict:
    with open(JAX_METRICS) as f:
        return json.load(f)


# (title, key, format) of each row; lower is better in each
ROWS = (("decoder flow NLL (cross)", "cross_nll", "{:.4f}"),
        ("reconstruction mel-L1 (cross)", "cross_recon_mel_l1", "{:.4f}"),
        ("speaker<->accent embedding cross-cov", "emb_cross_cov", "{:.5f}"))


def report(meta: dict, jax: dict) -> str:
    """REPORT.md: the port's rows beside the JAX package's, and whether
    the augmentation moved each metric the way it did in JAX."""
    res, jres = meta["results"], jax["results"]
    lines = []
    signs = {}
    for title, key, fmt in ROWS:
        na, au = res["no_aug"][key], res["aug"][key]
        jna, jau = jres["no_aug"][key], jres["aug"][key]
        better, jbetter = au < na, jau < jna
        signs[key] = better == jbetter
        lines.append(
            f"| {title} | {fmt.format(na)} | {fmt.format(au)} | "
            f"{'YES' if better else 'no'} | {fmt.format(jna)} | "
            f"{fmt.format(jau)} | {'YES' if jbetter else 'no'} |")
    nll_same = signs["cross_nll"]
    sign_note = (
        "The augmentation moves the cross NLL the way it did in the JAX "
        "package's run." if nll_same else
        "**The augmentation's effect on the cross NLL does not have the "
        "JAX package's sign** in this run: logged in ROADMAP Queue 3 as "
        "to explain.")
    other = [t for t, k, _ in ROWS[1:] if not signs[k]]
    if other:
        sign_note += (" Other rows whose sign differs from JAX's: "
                      + ", ".join(other) + ".")
    na, au = res["no_aug"], res["aug"]
    return f"""# Formant-augmentation disentanglement experiment (the port)

The port's run of `scripts/aug_disentangle_experiment.py`
(`python -m radmmm_torch.scripts.aug_disentangle_experiment`), on
{meta['device']['card']} (PyTorch {meta['device']['torch']}, CUDA
{meta['device']['cuda']}). The JAX package's run is in
`examples/aug_experiment/`.

**Setup.** The synthetic 4-speaker x 2-accent corpus
(`scripts/make_demo_corpus.py --accents --n-train {meta['n_train']}
--n-val {meta['n_val']}`): accent is a
systematic vowel-space chain shift, speaker an F0 base, a vocal-tract
formant scale and breathiness. Training data is confounded (each speaker
only in its native accent, two speakers an accent), the situation the reference's
formant-scaling augmentation targets. The held-out evaluation uses the
cross combinations (every speaker in the other accent). Two identical
{meta['steps']}-step trainings through the port's CLI, differing only in
`aug.yaml` (none/0.9/1.1 `scale_formant`) and the augmented-speaker table
expansion; the speaker-accent cross-covariance regularizer is off in both.
The two frameworks draw other initial weights, dropout bits and
augmentations, so the runs agree in kind, not in digits.

**Results** (held-out cross-accent split, {na['n_cross_utts']} utterances;
the port's columns first, then the JAX package's
`examples/aug_experiment/metrics.json`):

| metric | aug OFF | aug ON | aug better? | JAX aug OFF | JAX aug ON | JAX aug better? |
|---|---|---|---|---|---|---|
{chr(10).join(lines)}

{sign_note}

**Time** (on {meta['device']['card']}): `fit` {na['fit_seconds']:.1f} s
without the augmentation and {au['fit_seconds']:.1f} s with it, for
{meta['steps']} steps each, start to end of the CLI call (the first
batches, the whitening init, graph captures and the final checkpoint
included). {_fit_lines(meta.get('fit_stats', {}))}

**Reading.** Lower cross NLL and mel-L1 on unseen (speaker, accent)
combinations mean the decoder factorizes accent from voice instead of
memorizing their training-time pairing; a lower embedding
cross-covariance means speaker embeddings carry less accent information.

Reproduce: `python -m radmmm_torch.scripts.aug_disentangle_experiment`
(metrics.json in this directory has the exact numbers).
"""


def _fit_lines(stats: dict) -> str:
    """The fits' own accounts: ms a step, the loader's share, how many
    steps ran in whole groups and how many replayed a graph (on the
    card)."""
    return " ".join(
        f"{tag}: {s['ms_a_step']:.2f} ms a step, {100 * s['loader_share']:.1f}%"
        f" of it waiting on the loader, {s['megastep_steps']} of "
        f"{s['steps']} steps in whole groups, "
        f"{s.get('graphed_steps', 'not counted')} replayed a graph "
        f"({s.get('warmups', 'not counted')} graph warm-ups, "
        f"{s['captures']} captures, {s['replays']} replays)."
        for tag, s in stats.items())


def card() -> dict:
    from radmmm_torch.utils.device import card_line
    return {"card": (card_line() if torch.cuda.is_available()
                     else "the CPU (no card)"),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--workdir",
                    default=os.path.join(ROOT, "output", "aug_exp"))
    ap.add_argument("--outdir", default=os.path.join(
        ROOT, "examples", "torch_aug_experiment"))
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="the corpus's minimal model (tests)")
    ap.add_argument("--reuse", action="store_true",
                    help="skip arms whose result_<tag>.json already exists "
                         "in the workdir")
    # any other --dotted.key=value goes to both fits
    args, overrides = ap.parse_known_args(argv)

    from radmmm_torch.training.cli import main as cli_main
    from radmmm_torch.utils.device import resolve_device
    device = str(resolve_device(args.device))

    corpus = os.path.join(args.workdir, "corpus")
    if not os.path.exists(os.path.join(corpus, "aug.yaml")):
        subprocess.run(
            [sys.executable,
             os.path.join(ROOT, "scripts", "make_demo_corpus.py"), corpus,
             "--accents", "--n-train", str(args.n_train),
             "--n-val", str(args.n_val)] + (["--tiny"] if args.tiny else []),
            check=True)

    # the held-out cross combinations: every speaker in its non-native
    # accent
    import yaml
    cross_yaml = os.path.join(corpus, "cross.yaml")
    with open(os.path.join(corpus, "data.yaml")) as f:
        data_cfg = yaml.safe_load(f)
    val = data_cfg["data"]["init_args"]["valset_config"]
    cross_val = {k: dict(v, filelist=v["filelist"].replace("val_", "cross_"))
                 for k, v in val.items()}
    with open(cross_yaml, "w") as f:
        yaml.safe_dump({"data": {"init_args":
                                 {"valset_config": cross_val}}}, f)

    results, fit_stats = {}, {}
    for tag, extra in (("no_aug", []),
                       ("aug", [os.path.join(corpus, "aug.yaml")])):
        run_dir = os.path.join(args.workdir, f"run_{tag}")
        result_path = os.path.join(args.workdir, f"result_{tag}.json")
        if args.reuse and os.path.exists(result_path):
            with open(result_path) as f:
                results[tag] = json.load(f)
            print(tag, "(reused)", json.dumps(results[tag]))
            continue
        cfgs = [os.path.join(corpus, "model.yaml"),
                os.path.join(corpus, "data.yaml")] + extra
        t0 = time.perf_counter()
        _, trainer = cli_main(["fit", *[a for c in cfgs for a in ("-c", c)],
                  f"--model.output_directory={run_dir}",
                  f"--trainer.max_steps={args.steps}",
                  f"--model.iters_per_checkpoint={args.steps}",
                  "--trainer.val_check_interval=100000",
                  "--trainer.save_code_snapshot=False",
                  "--trainer.log_interval=100", "--device", device,
                  *overrides])
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        st = trainer.stats
        fit_stats[tag] = {
            "ms_a_step": 1e3 * st["train_s"] / max(st["steps"], 1),
            "loader_share": st["loader_wait_s"] / max(st["train_s"], 1e-9),
            **{k: st[k] for k in ("steps", "megastep_steps",
                                  "graphed_steps", "warmups", "captures",
                                  "replays")}}
        results[tag] = evaluate(cfgs, run_dir, cross_yaml, device)
        results[tag]["fit_seconds"] = round(fit_s, 1)
        with open(result_path, "w") as f:
            json.dump(results[tag], f)
        print(tag, json.dumps(results[tag]), json.dumps(fit_stats[tag]))

    os.makedirs(args.outdir, exist_ok=True)
    meta = {"steps": args.steps, "n_train": args.n_train,
            "n_val": args.n_val,
            "corpus": "4 speakers x 2 accents, confounded",
            "device": card(), "fit_stats": fit_stats, "results": results}
    with open(os.path.join(args.outdir, "metrics.json"), "w") as f:
        json.dump(meta, f, indent=1)
    text = report(meta, _jax_results())
    with open(os.path.join(args.outdir, "REPORT.md"), "w") as f:
        f.write(text)
    print(text)
    return meta


if __name__ == "__main__":
    main()
