#!/bin/bash
# Full preprocessing pipeline (steps 0-5), counterpart of
# scripts/run_full_preprocessing.sh. Usage:
#   bash pose_splatter_torch/scripts/run_full_preprocessing.sh <config.json> [camera.pkl] [extra args...]
# Extra arguments (e.g. --device cpu) reach every preprocessing command.
set -eo pipefail
CONFIG=${1:?usage: run_full_preprocessing.sh <config.json> [camera.pkl] [args...]}
shift
PKL=
if [ $# -gt 0 ] && [ "${1#-}" = "$1" ]; then
  PKL=$1
  shift
fi

LOGDIR=$(python -c "import sys,json;d=json.load(open(sys.argv[1]));print(d.get('project_directory','output'))" "$CONFIG")/logs
mkdir -p "$LOGDIR"

run() {
  echo "=== $* ==="
  "$@" 2>&1 | tee -a "$LOGDIR/preprocessing.log"
}

PRE="python -m pose_splatter_torch.scripts.preprocess"
if [ -n "$PKL" ]; then
  CAMH5=$(python -c "import sys,json,os;d=json.load(open(sys.argv[1]));print(os.path.join(d.get('project_directory',''), d['camera_fn']))" "$CONFIG")
  run $PRE convert_cameras "$PKL" "$CAMH5" "$@"   # step 0
fi
run $PRE auto_up "$CONFIG" "$@"                   # step 1
run $PRE center_rotation "$CONFIG" "$@"           # step 2
run $PRE crop_indices "$CONFIG" "$@"              # step 3
run $PRE write_images "$CONFIG" "$@"              # step 4
run $PRE to_zarr "$CONFIG" "$@"                   # step 5
echo "Preprocessing complete. Copy a suggested volume_idx into $CONFIG."
