"""Rerun SDK visualisation, optional: needs the ``rerun`` package
(counterpart of ``pose_splatter_tpu/viz/rerun_viz.py``).

Logs exported Gaussians as a Points3D entity (the reference's
``visualize_gaussian_rerun.py``) and a frame range of them to a ``.rrd``
timeline (``export_temporal_sequence_rerun.py``). The npz export
(``viz/export.py``) is the on-disk contract; Rerun is a host-side viewer.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np


def _rerun():
    try:
        import rerun as rr

        return rr
    except ImportError:
        raise ImportError(
            "The 'rerun-sdk' package is not installed; export to npz/PLY "
            "instead (scripts/export_gaussians.py) or install rerun-sdk.")


def log_gaussians(g: Dict[str, np.ndarray], entity: str = "gaussians",
                  rr=None) -> None:
    """Log one set of exported Gaussians as a Points3D entity."""
    rr = rr or _rerun()
    radii = g["scales"].mean(axis=1)
    colors = (np.clip(g["colors"], 0, 1) * 255).astype(np.uint8)
    rr.log(entity, rr.Points3D(g["means"], colors=colors, radii=radii))


def view_gaussian_npz(npz_path: str, save_rrd: Optional[str] = None,
                      spawn: bool = True) -> None:
    """Open an exported Gaussian npz in the Rerun viewer (or save .rrd)."""
    rr = _rerun()
    d = np.load(npz_path, allow_pickle=True)
    g = {k: d[k] for k in ("means", "scales", "colors")}
    rr.init("pose_splatter_torch", spawn=spawn and save_rrd is None)
    if save_rrd:
        rr.save(save_rrd)
    log_gaussians(g, rr=rr)


def log_temporal_sequence(model, dataset, frame_range: Iterable[int],
                          save_rrd: str, fps: float = 30.0) -> str:
    """Log a frame range of world-space Gaussians to a Rerun timeline."""
    rr = _rerun()
    from pose_splatter_torch.viz.export import extract_world_gaussians

    rr.init("pose_splatter_torch_sequence", spawn=False)
    rr.save(save_rrd)
    for frame in frame_range:
        mask, img, p_3d, angle, _ = dataset.get(frame, view_idx=0)
        g = extract_world_gaussians(model, mask, img, p_3d, angle,
                                    center_means=False)
        rr.set_time_seconds("time", frame / fps)
        log_gaussians(g, rr=rr)
    return save_rrd
