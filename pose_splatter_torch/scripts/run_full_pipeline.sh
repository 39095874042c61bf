#!/bin/bash
# End-to-end: preprocessing → training → evaluation → sample renders
# (counterpart of scripts/run_full_pipeline.sh).
# Usage: bash pose_splatter_torch/scripts/run_full_pipeline.sh <config.json> [epochs] [extra args...]
# Extra arguments (e.g. --device cpu) reach every command.
set -eo pipefail
CONFIG=${1:?usage: run_full_pipeline.sh <config.json> [epochs] [args...]}
shift
EPOCHS=50
if [ $# -gt 0 ] && [ "${1#-}" = "$1" ]; then
  EPOCHS=$1
  shift
fi
HERE=$(dirname "$0")

bash "$HERE/run_full_preprocessing.sh" "$CONFIG" "$@"
bash "$HERE/run_training.sh" "$CONFIG" --epochs "$EPOCHS" "$@"
python -m pose_splatter_torch.scripts.evaluate "$CONFIG" "$@"
python -m pose_splatter_torch.scripts.render_image "$CONFIG" --frame 0 --view 0 "$@"
echo "Pipeline complete."
