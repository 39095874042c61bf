"""Up-direction estimation (a copy of
``pose_splatter_tpu/preprocess/up_direction.py``; numpy, ``h5py`` imported
where it is used).

Two paths, matching the reference:

- ``auto_estimate_up`` — non-interactive: up = mean camera y-axis
  (``scripts/preprocessing/auto_estimate_up.py:14-29``).
- ``up_from_vertical_lines`` — the math behind the interactive tool
  (``scripts/preprocessing/estimate_up_direction.py:240-311``): each
  user-drawn vertical 2D segment in view i defines a plane through the
  camera center with normal ``n_world = Rᵀ Kᵀ l`` (l the homogeneous 2D
  line); the up direction is the least-eigenvalue eigenvector of
  ``Σ n nᵀ`` (most orthogonal to every plane normal). An interactive
  matplotlib frontend lives in the JAX package's
  ``scripts/estimate_up_direction.py``.

Both save ``vertical_lines.npz`` with an ``up`` key (consumed by
``get_cam_params``, ``src/utils.py:73-75``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def auto_estimate_up(camera_fn: str, output_fn: Optional[str] = None) -> np.ndarray:
    """Up = normalized mean of the cameras' world-space y-axes."""
    import h5py

    with h5py.File(camera_fn, "r") as f:
        rotation = np.array(f["camera_parameters"]["rotation"])  # [C,3,3]
    y_axes = rotation[:, :, 1]
    up = y_axes.mean(axis=0)
    up = up / np.linalg.norm(up)
    if output_fn is not None:
        np.savez(output_fn, up=up)
    return up


def up_from_vertical_lines(
    lines_all: Sequence[Sequence],  # per camera: list of ((u1,v1),(u2,v2))
    K: np.ndarray,  # [C,3,3]
    E: np.ndarray,  # [C,4,4]
) -> np.ndarray:
    """Estimate the world up direction from user-annotated vertical lines."""
    C = len(K)
    plane_normals = []
    for i in range(C):
        K_i = K[i]
        R_i = E[i][:3, :3]
        normals = []
        for seg in lines_all[i]:
            (u1, v1), (u2, v2) = seg
            # Homogeneous 2D line through the two points.
            line_abc = np.array(
                [v1 - v2, u2 - u1, u1 * v2 - u2 * v1], dtype=float
            )
            n_world = R_i.T @ (K_i.T @ line_abc)
            norm = np.linalg.norm(n_world)
            if norm > 1e-12:
                normals.append(n_world / norm)
        if normals:
            n_i = np.sum(normals, axis=0)
            plane_normals.append(n_i / np.linalg.norm(n_i))

    if not plane_normals:
        raise ValueError("No vertical lines in any camera; cannot estimate up.")

    M = np.zeros((3, 3))
    for n in plane_normals:
        M += np.outer(n, n)
    vals, vecs = np.linalg.eigh(M)
    up = vecs[:, np.argmin(vals)]
    return up / np.linalg.norm(up)
