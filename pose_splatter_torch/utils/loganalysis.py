"""Training-log parsing + 2D-vs-3D convergence comparison (a copy of
``pose_splatter_tpu/utils/loganalysis.py``: numpy and regular expressions).

The trainer's log format (``train/trainer.py``), the same in both packages:

    epoch 12: iou=0.12345 ssim=0.02345 img=0.34567
      validation: 0.56789

The reference regex-parses its tqdm ``epoch loss:`` lines; here each loss
component is recorded explicitly, so the comparison can plot per-component
curves as well as the total.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

_EPOCH_RE = re.compile(
    r"epoch (\d+): iou=([\d.eE+-]+) ssim=([\d.eE+-]+) img=([\d.eE+-]+)")
_VALID_RE = re.compile(r"validation: ([\d.eE+-]+)")


def parse_training_log(log_path: str) -> Dict[str, List[float]]:
    """Extract per-epoch loss components + validation scalars from a
    training log (robust to interleaved warnings/other output)."""
    with open(log_path) as f:
        content = f.read()
    epochs, iou, ssim, img = [], [], [], []
    for m in _EPOCH_RE.finditer(content):
        epochs.append(int(m.group(1)))
        iou.append(float(m.group(2)))
        ssim.append(float(m.group(3)))
        img.append(float(m.group(4)))
    total = [a + b + c for a, b, c in zip(iou, ssim, img)]
    return {
        "epochs": epochs,
        "iou": iou,
        "ssim": ssim,
        "img": img,
        "losses": total,
        "validation": [float(m.group(1))
                       for m in _VALID_RE.finditer(content)],
        "final_loss": total[-1] if total else None,
    }


def convergence_summary(data_2d: Dict, data_3d: Dict) -> Dict:
    """Tabular comparison: final losses, % reduction, epochs to reach
    within 10% of the final loss."""
    def stats(d):
        losses = d["losses"]
        if not losses:
            return {"final_loss": None}
        l0, lf = losses[0], losses[-1]
        thresh = lf * 1.1
        to_thresh = next(
            (e for e, l in zip(d["epochs"], losses) if l <= thresh),
            d["epochs"][-1] if d["epochs"] else None)
        return {
            "final_loss": lf,
            "loss_reduction_pct": 100.0 * (l0 - lf) / l0 if l0 else None,
            "epochs_to_within_10pct": to_thresh,
            "final_validation": d["validation"][-1]
            if d["validation"] else None,
        }

    return {"2d": stats(data_2d), "3d": stats(data_3d)}


def plot_convergence_comparison(data_2d: Dict, data_3d: Dict,
                                save_path: str = "convergence.pdf",
                                labels=("2D Mode", "3D Mode")) -> str:
    """Loss curves + loss-reduction-% curves, 2D vs 3D side by side."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    colors = ("tab:blue", "tab:red")

    ax = axes[0]
    for d, lab, col in zip((data_2d, data_3d), labels, colors):
        if d["losses"]:
            ax.plot(d["epochs"], d["losses"], label=lab, color=col, lw=2)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Total Loss")
    ax.set_title("Training Loss Comparison")
    ax.legend()
    ax.grid(True, alpha=0.3)

    ax = axes[1]
    for d, lab, col in zip((data_2d, data_3d), labels, colors):
        if d["losses"]:
            l0 = d["losses"][0]
            red = [100.0 * (l0 - l) / l0 for l in d["losses"]]
            ax.plot(d["epochs"], red, label=lab, color=col, lw=2)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss Reduction (%)")
    ax.set_title("Convergence Speed")
    ax.legend()
    ax.grid(True, alpha=0.3)

    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path
