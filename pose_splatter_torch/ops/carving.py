"""Shape carving: multi-camera silhouettes + RGB → colored voxel volume.

Counterpart of ``pose_splatter_tpu/ops/carving.py`` on its exact path
(``visibility_cap=None``, shared intrinsics for mask and color): one fused
4-channel nearest-pixel gather, then frontmost-voxel visibility for both
carve thresholds from one sort per camera, visibility-weighted colors, and
the two thresholds averaged into a ``[4, n1, n2, n3]`` volume.

The JAX code sorts by (pixel, distance) with ``lax.sort(num_keys=2)``,
stable in the voxel index. Here the two keys are packed into one int64
(pixel in the high word, the float32 bit pattern of the non-negative
distance in the low word, which orders like the float) and sorted stably,
which gives the same order and exactly one winner per pixel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pose_splatter_torch.utils.geometry import (
    camera_positions,
    project_points,
    transform_grid,
)


def _pixel_indices(
    pix: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Round (half to even, as ``jnp.round``) and clamp [.., 2] pixel coords
    → (x, y, flat) int64 indices."""
    x = torch.clamp(torch.round(pix[..., 0]), 0, width - 1).long()
    y = torch.clamp(torch.round(pix[..., 1]), 0, height - 1).long()
    return x, y, y * width + x


def sample_nearest_pixels(images: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel gather. images [C,H,W,ch]; pix [C,N,2] → [C,N,ch]."""
    C, H, W, ch = images.shape
    _, _, flat = _pixel_indices(pix, H, W)  # [C, N]
    images_flat = images.reshape(C, H * W, ch)
    return torch.gather(images_flat, 1, flat[..., None].expand(-1, -1, ch))


def ray_cast_visibility_pair(
    dists: torch.Tensor,  # [C, N] voxel-to-camera distances (>= 0)
    flat: torch.Tensor,   # [C, N] flattened pixel indices
    occ1: torch.Tensor,   # [N] bool (first threshold's occupied set)
    occ2: torch.Tensor,   # [N] bool (second threshold's occupied set)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frontmost-occupied-voxel visibility for both carve thresholds.

    One stable sort per camera by (pixel, distance); within each pixel
    segment the first voxel of each occupied set is the visible one
    (cumsum + segmented cummax, as ``carving.py:133-173``).
    """
    C, N = dists.shape
    dist_bits = dists.contiguous().view(torch.int32).long()
    key = (flat.long() << 32) | dist_bits
    _, order = torch.sort(key, dim=1, stable=True)  # [C, N]
    p_s = torch.gather(flat, 1, order)
    first = torch.ones_like(p_s, dtype=torch.bool)
    first[:, 1:] = p_s[:, 1:] != p_s[:, :-1]

    def first_occupied(occ):
        o = occ.long()[order]  # [C, N] occupancy in sorted order
        excl = torch.cumsum(o, dim=1) - o
        seg_base = torch.cummax(
            torch.where(first, excl, torch.full_like(excl, -1)), dim=1).values
        vis_s = (o > 0) & (excl == seg_base)
        vis = torch.empty_like(vis_s)
        vis.scatter_(1, order, vis_s)  # order is a permutation per camera
        return vis

    return first_occupied(occ1) & occ1[None, :], first_occupied(occ2) & occ2[None, :]


def carve_volume(
    mask: torch.Tensor,
    rgb: torch.Tensor,
    center: torch.Tensor,
    angle,
    grid: torch.Tensor,
    K_color: torch.Tensor,
    extrinsics: torch.Tensor,
    volume_fill_color: float = 0.45,
    nonvisible_weight: float = 0.25,
) -> torch.Tensor:
    """Full shape-carving forward (exact path).

    Args:
        mask:   [C, H, W] silhouettes in {0, 1} (float).
        rgb:    [C, H, W, 3] images in [0, 1].
        center: [3] world-space shift for this frame.
        angle:  scalar yaw for this frame.
        grid:   [n1, n2, n3, 3] canonical voxel grid.
        K_color:[C, 3, 3] intrinsics (mask and color share them).
        extrinsics: [C, 4, 4].

    Returns:
        volume [4, n1, n2, n3]: ch0 occupancy, ch1:4 RGB (empty voxels get
        ``volume_fill_color``), averaged over the two carve thresholds.
    """
    C = mask.shape[0]
    n1, n2, n3 = grid.shape[:3]
    N = n1 * n2 * n3

    pts = transform_grid(grid, center, angle).reshape(-1, 3)
    imgH, imgW = rgb.shape[1], rgb.shape[2]
    pix = project_points(pts, K_color, extrinsics, clamp_z=True)  # [C,N,2]
    fused = torch.cat([rgb, mask[..., None]], dim=-1)  # [C,H,W,4]
    samp = sample_nearest_pixels(fused, pix)  # [C,N,4]
    sampled = samp[..., :3]
    mask_flat = samp[..., 3].mean(dim=0)  # [N]

    cam_pos = camera_positions(extrinsics)  # [C,3]
    occ1 = mask_flat >= 1.0
    occ2 = mask_flat >= (C - 1.0) / C

    dists = torch.linalg.norm(pts[None] - cam_pos[:, None, :], dim=-1)
    _, _, flat = _pixel_indices(pix, imgH, imgW)
    vis1, vis2 = ray_cast_visibility_pair(dists, flat, occ1, occ2)

    out = torch.zeros((4, N), dtype=torch.float32, device=mask.device)
    for occupied, visible in ((occ1, vis1), (occ2, vis2)):
        weights = torch.where(visible, 1.0, nonvisible_weight)
        weights = weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)
        colors = torch.einsum("cn,cnk->nk", weights, sampled)  # [N,3]
        vol_rgb = torch.where(occupied[:, None], colors,
                              torch.full_like(colors, volume_fill_color))
        volume = torch.cat([occupied.float()[None, :], vol_rgb.T], dim=0)
        out = out + volume / 2.0
    return out.reshape(4, n1, n2, n3)
