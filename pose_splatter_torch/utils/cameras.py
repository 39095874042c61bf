"""Camera loading and synthetic cameras (host-side NumPy).

A copy of what the port needs from ``pose_splatter_tpu/utils/cameras.py``
(the port imports nothing of the JAX package):

- ``get_cam_params`` (``:92``): load HDF5 cameras, scale the intrinsics by
  the downsample factor, re-orient the world so the estimated up-direction
  maps to +z, recenter on the mean camera position and rescale so the
  farthest camera sits at distance 1;
- the adaptive-camera helpers (``:141-283``), copied as they are:
  ``triangulate_points``, ``_pairwise_triangulate``,
  ``triangulate_and_reproject``, ``weighted_median``,
  ``batch_weighted_median``, ``get_rough_center_3d``, ``_mask_medoids`` and
  ``adjust_principal_points_to_seed`` (per-frame principal-point
  re-centering on the mask medoids' DLT seed);
- ``w2c_to_c2w`` (``:131``): world-to-camera to camera-to-world in the
  reference's viewer convention;
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


def w2c_to_c2w(w2c: np.ndarray) -> np.ndarray:
    """World-to-camera → camera-to-world in the reference's viewer
    convention (``src/utils.py:115-120``): flip y/z columns, swap the first
    two rows, negate the third."""
    c2w = np.linalg.inv(w2c)
    c2w[:, 0:3, 1:3] *= -1
    c2w = c2w[:, [1, 0, 2, 3], :]
    c2w[:, 2] *= -1
    return c2w


# ----------------------------------------------------------------------------
# Triangulation (batched DLT).
# ----------------------------------------------------------------------------

def triangulate_points(P1, P2, x1, x2) -> np.ndarray:
    """Two-view triangulation via the 6x6 null-space construction, batched
    over points in one stacked SVD.

    ``P1,P2``: [3,4] projections; ``x1,x2``: [n,3] homogeneous image points.
    Returns [n,4] homogeneous world points (normalized by the last point's
    w, preserving the reference's convention ``src/utils.py:166-168``).
    """
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    if len(x1) != len(x2):
        raise ValueError("Number of points don't match.")
    n = len(x1)
    M = np.zeros((n, 6, 6))
    M[:, :3, :4] = P1
    M[:, 3:, :4] = P2
    M[:, :3, 4] = -x1
    M[:, 3:, 5] = -x2
    V = np.linalg.svd(M)[2]  # [n, 6, 6]
    X = V[:, -1, :4]
    return X / X[-1, 3]


def _pairwise_triangulate(pts: np.ndarray, Ps_sel: np.ndarray) -> np.ndarray:
    """All-pairs DLT positions from per-view pixels.

    ``pts`` [V,2], ``Ps_sel`` [V,3,4] → [V·(V−1)/2, 4] homogeneous points
    (each normalized to w=1), via ONE stacked SVD over every camera pair.
    """
    V = len(pts)
    ii, jj = np.triu_indices(V, k=1)
    xh = np.concatenate([pts, np.ones((V, 1))], axis=1)  # [V,3]
    m = len(ii)
    M = np.zeros((m, 6, 6))
    M[:, :3, :4] = Ps_sel[ii]
    M[:, 3:, :4] = Ps_sel[jj]
    M[:, :3, 4] = -xh[ii]
    M[:, 3:, 5] = -xh[jj]
    Vt = np.linalg.svd(M)[2]
    X = Vt[:, -1, :4]
    return X / X[:, 3:4]


def triangulate_and_reproject(points, Ps):
    """Pairwise triangulation over all camera pairs, median-aggregated.

    ``points``: length-C sequence of [2] pixel coordinates (None = missing);
    ``Ps``: [C,3,4]. Returns ``(reprojections [C,2], position [3])``.
    """
    Ps = np.asarray(Ps, np.float64)
    idx = np.array([i for i, p in enumerate(points) if p is not None], int)
    if len(idx) < 2:
        return points, np.nan * np.zeros(3)

    pts = np.asarray([points[i] for i in idx], np.float64).reshape(-1, 2)
    X = _pairwise_triangulate(pts, Ps[idx])  # [m,4]
    proj = np.einsum("cij,mj->mci", Ps, X)  # [m,C,3]
    proj = proj[..., :2] / proj[..., 2:3]
    return np.median(proj, axis=0), np.median(X[:, :3], axis=0)


# ----------------------------------------------------------------------------
# Rough 3D center from silhouettes.
# ----------------------------------------------------------------------------

def weighted_median(weights: np.ndarray) -> int:
    """Index where the cumulative mass first reaches half the total."""
    return int(batch_weighted_median(np.asarray(weights)[None])[0])


def batch_weighted_median(weights: np.ndarray) -> np.ndarray:
    """Row-wise weighted median index of [V, n] nonnegative weights."""
    c = np.cumsum(weights, axis=-1)
    reached = c >= 0.5 * c[:, -1:]
    idx = reached.argmax(axis=-1)
    # Preserve the reference's searchsorted(side='left') tie behavior: an
    # exact hit at half-mass selects that index (argmax over >= does too).
    return np.minimum(idx, weights.shape[-1] - 1)


def get_rough_center_3d(masks: np.ndarray, Ps: np.ndarray) -> np.ndarray:
    """Rough 3D center: per-view weighted-median of the mask's x/y
    marginals, triangulated across all view pairs."""
    assert masks.ndim == 3 and len(masks) == len(Ps)
    med_x = batch_weighted_median(masks.sum(axis=-2))  # column marginal → u
    med_y = batch_weighted_median(masks.sum(axis=-1))  # row marginal → v
    medians = np.stack([med_x, med_y], axis=1).astype(np.float64)  # [C,2]
    _, p_3d = triangulate_and_reproject(list(medians), Ps)
    return p_3d


# ----------------------------------------------------------------------------
# Adaptive camera (per-frame principal-point re-centering).
# ----------------------------------------------------------------------------

def _mask_medoids(masks: np.ndarray) -> np.ndarray:
    """Per-view (u, v) of the mask pixel nearest the mask centroid."""
    out = np.empty((len(masks), 2))
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if xs.size == 0:
            raise ValueError(f"Mask {i} is empty")
        d2 = (ys - ys.mean()) ** 2 + (xs - xs.mean()) ** 2
        j = int(np.argmin(d2))
        out[i] = (xs[j], ys[j])
    return out


def adjust_principal_points_to_seed(
    masks: np.ndarray,
    Ks: np.ndarray,
    extrinsics: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive-camera: shift each view's principal point so the DLT seed
    (triangulated from the mask medoids over ALL views jointly) reprojects
    exactly through its medoid. Returns ``(new_Ks [V,3,3], seed [3])``.
    """
    V = len(masks)
    assert Ks.shape == (V, 3, 3) and extrinsics.shape == (V, 4, 4)
    medoids = _mask_medoids(masks)  # [V,2] float64
    Ps = Ks @ extrinsics[:, :3, :]  # [V,3,4]

    # Joint DLT: rows [u·P3 − P1; v·P3 − P2] for every view at once.
    A = np.concatenate([
        medoids[:, 0:1] * Ps[:, 2] - Ps[:, 0],
        medoids[:, 1:2] * Ps[:, 2] - Ps[:, 1],
    ], axis=0)  # [2V, 4]
    X_h = np.linalg.svd(A)[2][-1]
    X = X_h[:3] / X_h[3]

    # cx', cy' so that K·(R·X + t) lands on the medoid in every view.
    X_cam = np.einsum("vij,j->vi", extrinsics[:, :3, :3], X) + extrinsics[:, :3, 3]
    uv = X_cam[:, :2] / X_cam[:, 2:3]
    f = np.stack([Ks[:, 0, 0], Ks[:, 1, 1]], axis=1)  # [V,2]
    new_Ks = Ks.copy()
    new_Ks[:, [0, 1], [2, 2]] = medoids - f * uv
    return new_Ks, X


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
