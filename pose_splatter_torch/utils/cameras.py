"""Camera loading and synthetic cameras (host-side NumPy).

A copy of what the eval slice needs from ``pose_splatter_tpu/utils/cameras.py``
(the port imports nothing of the JAX package):

- ``get_cam_params`` (``:92``): load HDF5 cameras, scale the intrinsics by
  the downsample factor, re-orient the world so the estimated up-direction
  maps to +z, recenter on the mean camera position and rescale so the
  farthest camera sits at distance 1;
- ``camera_extrinsic_spherical`` (``:285``): a camera on a sphere looking at
  the origin.

``h5py`` is imported only inside the function that reads the file.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit direction ``a`` to ``b`` (Rodrigues)."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    axis = np.cross(a, b)
    if np.abs(axis).sum() < 1e-6:  # (anti-)parallel: any perpendicular axis
        seed = np.array([1.0, 0, 0]) if abs(a[0]) < 1e-6 else np.array([0, 1.0, 0])
        axis = np.cross(a, seed)
    axis = axis / np.linalg.norm(axis)
    K = np.array([
        [0.0, -axis[2], axis[1]],
        [axis[2], 0.0, -axis[0]],
        [-axis[1], axis[0], 0.0],
    ])
    theta = np.arccos(np.clip(a @ b, -1.0, 1.0))
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _load_camera_h5(cam_fn: str):
    import h5py

    with h5py.File(cam_fn, "r") as f:
        grp = f["camera_parameters"]
        R = np.asarray(grp["rotation"], np.float64)
        t = np.asarray(grp["translation"], np.float64)
        K = np.asarray(grp["intrinsic"], np.float64)
    return K, R, t


def _orient_world(R: np.ndarray, t: np.ndarray, up: np.ndarray):
    """Rotate the world so ``up`` → +z, recenter on the mean camera position
    and rescale so the farthest camera sits at distance 1."""
    R2 = rotation_matrix_between(np.array([0.0, 0.0, 1.0]), up)
    center = np.einsum("cji,cj->i", R, t) / len(R)
    R_new = R @ R2.T
    t_new = t + R @ center
    positions = np.einsum("cji,cj->ci", R_new, t_new)
    t_new = t_new / np.abs(np.linalg.norm(positions, axis=1)).max()
    return R_new, t_new


def get_cam_params(
    cam_fn: str,
    ds: int = 1,
    auto_orient: bool = True,
    load_up_direction: bool = True,
    up_fn: str = "vertical_lines.npz",
    holdout_views: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load camera parameters from HDF5 and optionally re-orient the world.

    Returns ``(intrinsic [C,3,3], extrinsic [C,4,4], Ps [C,3,4])``.
    """
    K, R, t = _load_camera_h5(cam_fn)
    if ds != 1:
        K[:, [0, 1, 0, 1], [0, 1, 2, 2]] /= ds

    if auto_orient:
        if load_up_direction:
            if not os.path.exists(up_fn):
                raise FileNotFoundError(f"up-direction file not found: {up_fn}")
            up = -np.load(up_fn)["up"]
        else:
            up = np.mean(R[:, :3, 1], axis=0)
            up = up / np.linalg.norm(up)
        R, t = _orient_world(R, t, up)

    C = len(K)
    extrinsic = np.broadcast_to(np.eye(4), (C, 4, 4)).copy()
    extrinsic[:, :3, :3] = R
    extrinsic[:, :3, 3] = t
    Ps = K @ extrinsic[:, :3, :]

    keep = slice(None)
    if holdout_views is not None:
        keep = np.setdiff1d(np.arange(C), np.asarray(holdout_views, int))
    return K[keep], extrinsic[keep], Ps[keep]


def camera_extrinsic_spherical(radius: float, theta: float, phi: float) -> np.ndarray:
    """OpenCV-convention extrinsic for a camera on a sphere looking at the
    origin, up aligned with -z."""
    C = radius * np.array([
        np.sin(theta) * np.cos(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(theta),
    ])
    forward = -C / np.linalg.norm(C)
    right = np.cross([0.0, 0.0, -1.0], forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    R = np.stack([right, up, forward], 1).T
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ C
    return E
