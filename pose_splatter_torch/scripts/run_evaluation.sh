#!/bin/bash
# Evaluation wrapper (counterpart of scripts/run_evaluation.sh).
# Usage: bash pose_splatter_torch/scripts/run_evaluation.sh <config.json> [extra evaluate args...]
set -eo pipefail
CONFIG=${1:?usage: run_evaluation.sh <config.json> [args...]}
shift
python -m pose_splatter_torch.scripts.evaluate "$CONFIG" "$@" 2>&1 | tee -a evaluation.log
