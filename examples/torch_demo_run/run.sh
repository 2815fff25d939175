#!/usr/bin/env bash
# The port's 3,000-step demo run on one CUDA card: the JAX package's demo
# recipe (examples/demo_run/README.md) unchanged, through radmmm_torch's
# training CLI, then predict on the corpus's prompts.
#
#   examples/torch_demo_run/run.sh OUT_DIR [CORPUS_DIR]
#
# Run from the repository root. The corpus and the run directory (with its
# checkpoints) go to CORPUS_DIR (output/demo_corpus by default); OUT_DIR
# receives what the report needs and nothing large: the card's name and
# power limit, the fit and predict logs, tb/metrics.jsonl, the first and
# last validation's artifacts and the predictions. Then
#
#   python scripts/extract_demo_report.py OUT_DIR/run examples/torch_demo_run
#
# renders the curves and writes summary.json (it needs matplotlib).
set -euo pipefail
out=${1:?usage: run.sh OUT_DIR [CORPUS_DIR]}
corpus=${2:-output/demo_corpus}
mkdir -p "$out/run/tb" "$out/run/val_artifacts"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
    | tee "$out/versions.txt"
python scripts/make_demo_corpus.py "$corpus" | tee "$out/corpus.log"
cfg=(-c "$corpus/model.yaml" -c "$corpus/data.yaml")
start=$(date +%s)
python -m radmmm_torch.training.cli fit "${cfg[@]}" 2>&1 | tee "$out/fit.log"
echo "fit wall $(( $(date +%s) - start )) s" | tee -a "$out/fit.log"
python -m radmmm_torch.training.cli predict "${cfg[@]}" \
    "--data.init_args.inference_transcript=$corpus/prompts.json" 2>&1 \
    | tee "$out/predict.log"
run="$corpus/run"
cp "$run/tb/metrics.jsonl" "$out/run/tb/"
steps=$(ls "$run/val_artifacts" | sort)
for d in $(echo "$steps" | head -n 1) $(echo "$steps" | tail -n 1); do
    cp -r "$run/val_artifacts/$d" "$out/run/val_artifacts/"
done
cp -r "$run/predictions" "$out/run/"
