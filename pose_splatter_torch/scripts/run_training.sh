#!/bin/bash
# Training wrapper with logging (counterpart of scripts/run_training.sh).
# Usage: bash pose_splatter_torch/scripts/run_training.sh <config.json> [extra train args...]
# Extra arguments reach the CLI, e.g. --epochs 2 --device cpu.
set -eo pipefail
CONFIG=${1:?usage: run_training.sh <config.json> [args...]}
shift
LOGDIR=$(python -c "import sys,json;d=json.load(open(sys.argv[1]));print(d.get('project_directory','output'))" "$CONFIG")/logs
mkdir -p "$LOGDIR"
python -m pose_splatter_torch.scripts.train "$CONFIG" "$@" 2>&1 | tee -a "$LOGDIR/training.log"
