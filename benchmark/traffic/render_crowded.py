"""``render_sequence``'s recording with a larger animal: the ellipsoid's
semi-axes times ``axes_scale`` (the cell's workload file), so that more
voxels carve than ``max_n`` keeps. The selection then runs saturated, the
binning and the compositor at the full count of Gaussians, and the
opacities of the Gaussians kept sit near the threshold's.

Everything else is ``render_sequence``'s (its parameters, loop, latency
and ``correct``), as ``train_kstep`` builds on ``train_eager``.
"""

from __future__ import annotations

from benchmark import program
from benchmark.traffic import render_sequence


class Session(render_sequence.Session):
    def __init__(self, cell, seed: int, device):
        scale = float(cell.workload["axes_scale"])
        # ``program.Inputs`` draws the frames with ``program.AXES``.
        axes = program.AXES
        program.AXES = tuple(scale * a for a in axes)
        try:
            super().__init__(cell, seed, device)
        finally:
            program.AXES = axes
