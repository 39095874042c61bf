"""3D Gaussian → screen-space projection (EWA splatting), counterpart of
``pose_splatter_tpu/ops/projection.py``.

gsplat's classic projection: world → camera by the viewmat, the
perspective Jacobian at the mean with the tangent-plane coordinates clamped
to 1.3× the field of view, 2D covariance J Σ_cam Jᵀ + 0.3·I, conic = its
inverse, radius = ceil(3σ) of the dominant eigenvalue. Culling gives a
validity mask; nothing is compacted.

The expressions are the JAX package's, term for term and in its order
(``projection.py:67-131``): the conic gates and the ``ceil`` in the radius
turn a float rounding into a discrete change, and a radius one pixel off
changes the binning and so the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose_splatter_torch.utils.geometry import quat_normalize, quat_to_rotmat


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians of one or more cameras ([..., N, ...])."""

    mean2d: torch.Tensor  # [..., N, 2] pixel coordinates
    conic: torch.Tensor  # [..., N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # [..., N] camera-space z
    radius: torch.Tensor  # [..., N] conservative pixel radius
    valid: torch.Tensor  # [..., N] bool: in frustum, invertible, radius > clip


def quat_scale_to_covar(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[N,4] quats (need not be unit) + [N,3] scales → [N,3,3] covariance."""
    R = quat_to_rotmat(quat_normalize(quats))
    M = R * scales[..., None, :]  # R @ diag(s)
    return torch.einsum("...ij,...kj->...ik", M, M)


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
) -> ProjectedGaussians:
    """Project [N] world-space Gaussians (means [N,3], quats [N,4], linear
    scales [N,3]) into cameras viewmat [4,4] / K [3,3], or a batch of
    cameras [B,4,4] / [B,3,3] (results then carry a leading [B])."""
    if viewmat.dim() == 3:
        # Per-camera scalars broadcast over the Gaussians, as JAX's vmap.
        viewmat, K = viewmat[:, None], K[:, None]
    Rcw = viewmat[..., :3, :3]
    tcw = viewmat[..., :3, 3]
    wx, wy, wz = means[:, 0], means[:, 1], means[:, 2]
    mcx = Rcw[..., 0, 0] * wx + Rcw[..., 0, 1] * wy + Rcw[..., 0, 2] * wz + tcw[..., 0]
    mcy = Rcw[..., 1, 0] * wx + Rcw[..., 1, 1] * wy + Rcw[..., 1, 2] * wz + tcw[..., 1]
    depth = Rcw[..., 2, 0] * wx + Rcw[..., 2, 1] * wy + Rcw[..., 2, 2] * wz + tcw[..., 2]

    R = quat_to_rotmat(quat_normalize(quats))  # [N,3,3]
    M = R * scales[..., None, :]  # R @ diag(s)
    m0, m1, m2 = M[:, 0], M[:, 1], M[:, 2]  # [N,3] rows of M

    def row(i):
        c = Rcw[..., i, :, None]  # [..., 3, 1]: scalars against [N, 3] rows
        return c[..., 0, :] * m0 + c[..., 1, :] * m1 + c[..., 2, :] * m2

    a0, a1, a2 = row(0), row(1), row(2)  # rows of Rcw @ M
    c00 = (a0 * a0).sum(-1)
    c01 = (a0 * a1).sum(-1)
    c02 = (a0 * a2).sum(-1)
    c11 = (a1 * a1).sum(-1)
    c12 = (a1 * a2).sum(-1)
    c22 = (a2 * a2).sum(-1)

    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    z = depth
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    tx = _clip(mcx / safe_z, 1.3 * tan_fovx) * z
    ty = _clip(mcy / safe_z, 1.3 * tan_fovy) * z

    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    a = j00 * (j00 * c00 + 2.0 * j02 * c02) + j02 * j02 * c22 + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + 2.0 * j12 * c12) + j12 * j12 * c22 + eps2d
    det = a * c - b * b
    safe_det = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c / safe_det, -b / safe_det, a / safe_det], -1)

    mean2d = torch.stack([fx * mcx * inv_z + cx, fy * mcy * inv_z + cy], -1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    inside = ((mean2d[..., 0] + radius > 0) & (mean2d[..., 0] - radius < width)
              & (mean2d[..., 1] + radius > 0) & (mean2d[..., 1] - radius < height))
    valid = ((depth > near_plane) & (depth < far_plane) & (det > 0)
             & (radius > radius_clip) & inside)
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=depth,
                              radius=radius, valid=valid)


def _clip(x: torch.Tensor, lim: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, -lim, lim)`` with a per-camera ``lim`` tensor."""
    return torch.minimum(torch.maximum(x, -lim), lim)
