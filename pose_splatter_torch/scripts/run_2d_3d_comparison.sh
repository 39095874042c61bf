#!/bin/bash
# Train + evaluate both renderer modes and diff the metrics (counterpart of
# scripts/run_2d_3d_comparison.sh).
# Usage: bash pose_splatter_torch/scripts/run_2d_3d_comparison.sh <config_3d.json> <config_2d.json> [epochs] [extra args...]
# Extra arguments (e.g. --device cpu) reach every command.
set -eo pipefail
CFG3D=${1:?usage: run_2d_3d_comparison.sh <config_3d.json> <config_2d.json> [epochs] [args...]}
CFG2D=${2:?need a 2D config}
shift 2
EPOCHS=20
if [ $# -gt 0 ] && [ "${1#-}" = "$1" ]; then
  EPOCHS=$1
  shift
fi

LOG3D=$(python -c "import json,sys;print(json.load(open(sys.argv[1]))['project_directory'])" "$CFG3D")/train_3d.log
LOG2D=$(python -c "import json,sys;print(json.load(open(sys.argv[1]))['project_directory'])" "$CFG2D")/train_2d.log

echo "=== 3D mode ==="
python -m pose_splatter_torch.scripts.train "$CFG3D" --epochs "$EPOCHS" "$@" 2>&1 | tee "$LOG3D"
python -m pose_splatter_torch.scripts.evaluate "$CFG3D" "$@"

echo "=== 2D mode ==="
python -m pose_splatter_torch.scripts.train "$CFG2D" --epochs "$EPOCHS" "$@" 2>&1 | tee "$LOG2D"
python -m pose_splatter_torch.scripts.evaluate "$CFG2D" "$@"

echo "=== convergence curves (analyze_results.py parity) ==="
python -m pose_splatter_torch.scripts.analyze_convergence --log2d "$LOG2D" --log3d "$LOG3D" \
  --plot "$(dirname "$LOG2D")/convergence_comparison.pdf" \
  --out "$(dirname "$LOG2D")/convergence_summary.json" "$@"

echo "=== comparison ==="
python - "$CFG3D" "$CFG2D" <<'PY'
import json, sys
for cfg_fn in sys.argv[1:3]:
    cfg = json.load(open(cfg_fn))
    fn = cfg["project_directory"] + "/evaluation_metrics.json"
    m = json.load(open(fn))
    print(cfg_fn, {k: round(v["mean"], 4) for k, v in m.items()
                   if isinstance(v, dict)})
PY
