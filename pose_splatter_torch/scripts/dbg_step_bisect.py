"""Bisect the north-star train step's time by toggling its components
(counterpart of ``scripts/dbg_step_bisect.py``).

    python -m pose_splatter_torch.scripts.dbg_step_bisect
        [all|full|nossim|ablation|unet1] [--device cuda|cpu] [--seed N]
        [--iters N] [size flags of dbg_model_breakdown]

``dbg_model_breakdown``'s model and frame (576x512, grid 128 cropped to
128x128x64, 6 cameras, holdout [5], 2D, min_n 512, max_n 8192,
``"kernel"`` render mode) trained through ``train/loop.py::
make_train_step`` (Adam lr 1e-3, img 0.5), a fresh model a line. Lines,
in the script's order: full step (ssim 0.1), no ssim (ssim 0), ablation
(no unets: the carve's volume is the U-Nets' output), 1 unet; each the
mean ms of 5 steps after one (``probe_common``), each step from where the
last left the weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from pose_splatter_torch.scripts import probe_common as pc
from pose_splatter_torch.scripts.dbg_model_breakdown import (
    model_and_frame,
    size_args,
    sizes,
)
from pose_splatter_torch.train.loop import create_train_state, make_train_step

RUNS = (("full", "full step", dict()),
        ("nossim", "no ssim", dict(ssim=0.0)),
        ("ablation", "ablation (no unets)", dict(ablation=True)),
        ("unet1", "1 unet", dict(num_unets=1)))


def run(which: str = "all", device="cuda", seed: int = 0, iters: int = 5,
        **size) -> Dict:
    probe = pc.Probe(device, iters, width=28, fmt="9.2f")
    for key, name, kw in RUNS:
        if which not in ("all", key):
            continue
        model, batch = model_and_frame(
            probe.dev, seed, ablation=kw.get("ablation", False),
            num_unets=kw.get("num_unets", 3), **size)
        state = create_train_state(model, 1e-3)
        step = make_train_step(model, state.optimizer, img_lambda=0.5,
                               ssim_lambda=kw.get("ssim", 0.1))
        probe.time(name, lambda: step(state, batch))
        del model, state, step
    return probe.result(which=which)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=5)
    ap.add_argument("which", nargs="?", default="all",
                    choices=["all"] + [k for k, _, _ in RUNS])
    size_args(ap)
    a = ap.parse_args(argv)
    return run(a.which, a.device, a.seed, a.iters, **sizes(a))


if __name__ == "__main__":
    main()
