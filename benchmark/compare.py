"""The numbers that decide ``correct``, and the compositors' least work on
the arrays a traced run's marks kept.

Training (``train_checks``), each a gap of the program's reading from the
reference's:

- ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the
  checked steps;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient (as Adam holds it after step 1) and the
  reference's, over the larger of the reference leaf's norm and the
  median leaf's; a leaf the reference's loss does not reach has to have
  no gradient;
- ``step_gap``: the same of each leaf's change after the checked steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (below that a leaf moves under Adam by round-off
  alone); a leaf the reference leaves unmoved has to stay unmoved.

Rendering (``render_checks``), over the frames kept from the window:
``rgb_gap``, the largest absolute difference between the float image the
program's forward returned and the reference's; ``mismatch``, the largest
share of the uint8 values the host received that differ from the
reference's image rounded the same way. A cell's workload file names the
numbers it compares, each with its limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import counts
from benchmark.reference.model import CHUNK, TILE

MOVED_SHARE = 1e-3


def _gap(a: Optional[float], b: float, scale: float) -> float:
    return abs((a or 0.0) - b) / scale


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            np.isfinite(prog["losses"])):
        losses.append(float("inf"))
    g_ref = ref["grad_norms"]
    reached = {k: v for k, v in g_ref.items() if v is not None}
    med_g = statistics.median(reached.values())
    grad = 0.0
    for k, r in g_ref.items():
        p = prog["grad_norms"].get(k)
        if r is None:
            grad = max(grad, (p or 0.0) / med_g)
        else:
            grad = max(grad, _gap(p, r, max(r, med_g)))
    moved = [k for k, v in reached.items() if v >= MOVED_SHARE * med_g]
    c_ref, c_prog = ref["change_norms"], prog["change_norms"]
    med_c = statistics.median(c_ref[k] for k in moved)
    step = 0.0
    for k in c_ref:
        if k in moved:
            step = max(step, _gap(c_prog.get(k), c_ref[k], max(c_ref[k], med_c)))
        elif g_ref[k] is None:
            step = max(step, (c_prog.get(k) or 0.0) / med_c)
    return dict(loss_gap=max(losses), grad_gap=grad, step_gap=step)


def _checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    return {k: dict(value=float(v), limit=float(limits[k]))
            for k, v in values.items()}


def train_checks(prog: Dict, ref: Dict, limits: Dict[str, float]) -> Dict:
    gaps = train_gaps(prog, ref)
    return _checks({k: gaps[k] for k in limits}, limits)


def mismatch(u8_prog: np.ndarray, u8_ref: np.ndarray) -> float:
    """Share of the uint8 values that differ."""
    return float(np.mean(u8_prog != u8_ref))


def render_gaps(kept, ref: Dict) -> Dict[str, float]:
    """kept: (pose, uint8 host image, float image); ref: pose -> float
    image."""
    if not kept:
        return dict(rgb_gap=float("inf"), mismatch=float("inf"))
    rgb = max(float((img - ref[p]).abs().max()) for p, _, img in kept)
    share = max(mismatch(u8, u8_host(ref[p])) for p, u8, _ in kept)
    return dict(rgb_gap=rgb, mismatch=share)


def render_checks(kept, ref: Dict, limits: Dict[str, float]) -> Dict:
    gaps = render_gaps(kept, ref)
    return _checks({k: gaps[k] for k in limits}, limits)


def compositor_bounds(values: Dict, spec) -> Dict[str, list]:
    """Least seconds of each marked compositor call: the forward's from the
    arrays each "binning" mark kept (its chunks walked found by running the
    program's forward compositor on them again), the backward's from each
    "kernel_bwd" mark's arguments."""
    from pose_splatter_torch.ops.rasterize_kernels import composite_instances

    mode = "conic" if spec.mode == "3d" else "ellipse"
    out = {"composite_fwd": [], "composite_bwd": []}
    for b in values.get("binning", []):
        jstop = composite_instances(b.inst, b.astarts, b.counts, b.origins,
                                    TILE, CHUNK, mode)[2]
        out["composite_fwd"].append(
            counts.kernel_bound(b.counts, jstop, TILE, CHUNK)["seconds"])
    for args in values.get("kernel_bwd", []):
        inst, _, _, cnt, _, jstop = args[:6]
        out["composite_bwd"].append(
            counts.bwd_bound(inst.shape[0], cnt, jstop, TILE, CHUNK)["seconds"])
    return out


def u8_host(rgb: torch.Tensor) -> np.ndarray:
    return torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
