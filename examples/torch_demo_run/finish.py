"""Finish the port's demo report from what run.sh brought back.

    python examples/torch_demo_run/finish.py OUT_DIR COMMIT

OUT_DIR is run.sh's output directory, COMMIT the commit the run ran. Runs
scripts/extract_demo_report.py (which needs matplotlib) over OUT_DIR/run
into a directory beside it, then writes into examples/torch_demo_run/ the
loss curves, the first and last validation's attention maps, one
validation TTS sample and one ``predict`` output, run.sh's logs (the
corpus's paths in them relative to the repository root), and
summary.json: the report's summary with ``device`` (the card's name and
power limit, as nvidia-smi gave them) and ``commit`` added and
``artifacts`` naming the files kept.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KEEP = ("loss_curves.png", "attribute_losses.png",
        "first_step250_attention_soft.png", "first_step250_attention_hard.png",
        "last_step3000_attention_soft.png", "last_step3000_attention_hard.png",
        "final_val_tts_sample_0.wav")


def main(out_dir: str, commit: str) -> dict:
    report = os.path.join(out_dir, "report")
    subprocess.run([sys.executable, os.path.join(
        HERE, "..", "..", "scripts", "extract_demo_report.py"),
        os.path.join(out_dir, "run"), report], check=True)
    with open(os.path.join(report, "summary.json")) as f:
        summary = json.load(f)
    for name in KEEP:
        shutil.copy(os.path.join(report, name), os.path.join(HERE, name))
    shutil.copy(os.path.join(out_dir, "run", "predictions",
                             "output_sample_0_tts.wav"),
                os.path.join(HERE, "final_prediction_0.wav"))
    for log in ("fit.log", "predict.log"):
        with open(os.path.join(out_dir, log)) as f:
            text = f.read()
        # the corpus's paths relative to the repository root, as run.sh
        # names them
        with open(os.path.join(HERE, log), "w") as f:
            f.write(re.sub(r"\S*/(output/demo_corpus)", r"\1", text))
    with open(os.path.join(out_dir, "card.txt")) as f:
        summary["device"] = f.read().strip()
    summary["commit"] = commit
    summary["artifacts"] = list(KEEP) + ["final_prediction_0.wav"]
    with open(os.path.join(HERE, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2]), indent=1))
