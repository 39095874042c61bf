"""Voxel grids, pinhole projection and yaw rotations on tensors.

Counterpart of ``pose_splatter_tpu/utils/geometry.py``. The quaternion
helpers serve only the 3D path and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


def create_3d_grid(
    length: float, n: int, volume_idx: Optional[Sequence[Sequence[int]]] = None
) -> np.ndarray:
    """n×n×n lattice of 3D points spanning ``[-length/2, length/2]``,
    optionally cropped to ``volume_idx`` ranges. Returns [n1,n2,n3,3] f32."""
    offset = np.linspace(-length / 2, length / 2, n)
    gx, gy, gz = np.meshgrid(offset, offset, offset, indexing="ij")
    grid = np.stack([gx, gy, gz], axis=-1)
    if volume_idx is not None:
        (i1, i2), (i3, i4), (i5, i6) = volume_idx
        grid = grid[i1:i2, i3:i4, i5:i6]
    return grid.astype(np.float32)


def project_points(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    eps: float = 1e-8,
    clamp_z: bool = False,
) -> torch.Tensor:
    """Project world points [N,3] into pixel coordinates for cameras
    [C,3,3] / [C,4,4] (or unbatched [3,3] / [4,4]).

    ``clamp_z`` normalizes by ``max(z, eps)``, otherwise by ``z + eps``.
    Returns [C,N,2] (or [N,2] for unbatched cameras).
    """
    squeeze = intrinsics.dim() == 2
    K = intrinsics.reshape(-1, 3, 3)
    E = extrinsics.reshape(-1, 4, 4)
    pts_h = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)  # [N,4]
    cam = torch.einsum("cij,nj->cni", E, pts_h)[..., :3]  # [C,N,3]
    pix_h = torch.einsum("cij,cnj->cni", K, cam)  # [C,N,3]
    z = pix_h[..., 2:3]
    denom = torch.clamp(z, min=eps) if clamp_z else z + eps
    pix = pix_h[..., :2] / denom
    if squeeze:
        pix = pix[0]
    return pix


def camera_positions(extrinsics: torch.Tensor) -> torch.Tensor:
    """World-space camera centers ``-Rᵀ t`` for [C,4,4] extrinsics."""
    R = extrinsics[..., :3, :3]
    t = extrinsics[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)


def yaw_rotation(angle: Union[float, torch.Tensor],
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """[3,3] float32 rotation about +z by ``angle`` (radians)."""
    a = torch.as_tensor(angle, dtype=torch.float32, device=device)
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def transform_grid(grid: torch.Tensor, center: torch.Tensor, angle) -> torch.Tensor:
    """Yaw-rotate then shift a [n1,n2,n3,3] grid."""
    rot = yaw_rotation(angle, device=grid.device)
    out = torch.einsum("abci,ji->abcj", grid, rot)
    return out + center.reshape(1, 1, 1, 3)
