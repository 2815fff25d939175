"""The graphed trainer's memory over a fit that captures many graphs.

Builds the demo recipe's corpus (``scripts/make_demo_corpus.py``, the
recipe of ``examples/torch_demo_run``) with ``--n-train`` utterances, then
fits it through the port's CLI twice, each in a process of its own so
that neither sees the other's cached memory: with megastep_k 8 (groups of
8 same-shape batches from the loader, validated and saved once a group)
and with megastep_k 1 (the loader's featurized batches one at a time).
Every step of both runs through the graphed step: one graph per batch
shape, phase and RAdam branch, captured at its second step, all in the
trainer's one pool. For each fit it records the steps, the steps in whole
groups and those that replayed a graph, the warm-ups, every capture (its
key, shape, seconds and the bytes it grew the pool by), the replays, ms a
step and the card's peak reserved and allocated memory.

    python -m radmmm_torch.scripts.graph_fit_memory [--n-train 480]
        [--steps 1000] [--workdir output/graph_fit_memory]
        [--out chiprun_out/graph_fit_memory.json]

The demo corpus as ``examples/torch_demo_run`` builds it (48 training
utterances) has 6 batches an epoch, so megastep_k 8 forms no whole group
there; 480 utterances give 60 batches an epoch at four shapes. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def _shape(signature: tuple) -> list:
    """The largest input shape of a capture's signature (the batch's
    audio)."""
    shapes = [s[0] for s in signature[3:]
              if isinstance(s, tuple) and len(s) == 3]
    return list(max(shapes, key=lambda x: torch.Size(x).numel()))


def fit_arm(corpus: str, run_dir: str, steps: int, k: int) -> dict:
    """One fit of the demo recipe at megastep_k ``k``, in this process."""
    from radmmm_torch.training.cli import main as cli_main
    cfgs = [os.path.join(corpus, "model.yaml"),
            os.path.join(corpus, "data.yaml")]
    t0 = time.perf_counter()
    _, trainer = cli_main([
        "fit", *[a for c in cfgs for a in ("-c", c)],
        f"--model.output_directory={run_dir}",
        f"--trainer.max_steps={steps}",
        f"--model.iters_per_checkpoint={steps}",
        f"--trainer.megastep_k={k}",
        "--trainer.val_check_interval=100000",
        "--trainer.save_code_snapshot=False",
        "--trainer.log_interval=100", "--device", "cuda"])
    torch.cuda.synchronize()
    st = trainer.stats
    pool = trainer._graph_pool
    return {
        "megastep_k": k, "fit_s": time.perf_counter() - t0,
        "ms_a_step": 1e3 * st["train_s"] / max(st["steps"], 1),
        "steps": st["steps"], "megastep_steps": st["megastep_steps"],
        "graphed_steps": st["graphed_steps"], "warmups": st["warmups"],
        "replays": st["replays"], "pool_bytes": st["graph_pool_bytes"],
        "peak_reserved_bytes": st["peak_reserved_bytes"],
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "captures": [{"key": list(c.signature[0]), "shape": _shape(
            c.signature), "seconds": c.seconds, "pool_bytes": c.pool_bytes}
            for c in pool.captures]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=480)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--workdir",
                    default=os.path.join(ROOT, "output", "graph_fit_memory"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "graph_fit_memory.json"))
    ap.add_argument("--arm", type=int, default=None,
                    help="run only the fit at this megastep_k, in this "
                         "process, and print its record")
    args = ap.parse_args(argv)
    corpus = os.path.join(args.workdir, "corpus")
    if args.arm is not None:
        rec = fit_arm(corpus, os.path.join(args.workdir, f"run_{args.arm}"),
                      args.steps, args.arm)
        print("ARM " + json.dumps(rec))
        return rec
    if not torch.cuda.is_available():
        sys.exit("graph_fit_memory: needs a CUDA card")
    if not os.path.exists(os.path.join(corpus, "model.yaml")):
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "scripts", "make_demo_corpus.py"),
                        corpus, "--n-train", str(args.n_train)], check=True)
    arms = []
    for k in (8, 1):
        out = subprocess.run(
            [sys.executable, "-m", "radmmm_torch.scripts.graph_fit_memory",
             "--arm", str(k), "--steps", str(args.steps),
             "--workdir", args.workdir], cwd=ROOT, check=True,
            stdout=subprocess.PIPE, text=True).stdout
        print(out[-3000:])
        arms.append(json.loads(next(line for line in out.splitlines()
                                    if line.startswith("ARM "))[4:]))
    meta = {"device": card(), "n_train": args.n_train, "steps": args.steps,
            "arms": arms}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(meta, f, indent=1)
    for a in arms:
        caps = a["captures"]
        later = [c["pool_bytes"] for c in caps[1:]]
        print(f"megastep_k {a['megastep_k']}: {a['steps']} steps, "
              f"{a['megastep_steps']} in whole groups, "
              f"{a['graphed_steps']} replayed a graph, {a['ms_a_step']:.2f} "
              f"ms a step; {len(caps)} captures, {a['replays']} replays, "
              f"pool {a['pool_bytes'] / 2**20:.1f} MiB (first capture "
              f"+{caps[0]['pool_bytes'] / 2**20 if caps else 0:.1f} MiB, "
              f"later ones at most "
              f"+{max(later, default=0) / 2**20:.1f} MiB); peak reserved "
              f"{a['peak_reserved_bytes'] / 2**20:.1f} MiB, allocated "
              f"{a['peak_allocated_bytes'] / 2**20:.1f} MiB ({meta['device']})")
    return meta


if __name__ == "__main__":
    main()
