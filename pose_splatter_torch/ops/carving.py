"""Shape carving: multi-camera silhouettes + RGB → colored voxel volume.

``get_volume`` is the plain averaged back-projection that preprocessing
carves with, for one frame or a batch of frames at once.

Counterpart of ``pose_splatter_tpu/ops/carving.py::carve_volume``: the
nearest-pixel gathers (one fused 4-channel gather when mask and color share
intrinsics, a separate mask projection for the adaptive camera's
``K_mask``), then frontmost-voxel visibility for both carve thresholds from
one sort per camera, visibility-weighted colors, and the two thresholds
averaged into a ``[4, n1, n2, n3]`` volume.

The JAX code sorts by (pixel, distance) with ``lax.sort(num_keys=2)``,
stable in the voxel index. Here the two keys are packed into one int64
(pixel in the high word, the float32 bit pattern of the non-negative
distance in the low word, which orders like the float) and sorted stably,
which gives the same order and exactly one winner per pixel.

With ``visibility_cap`` the visibility sort runs on a static-shape
compaction of the occupied set (:func:`compact_occupied`). Nothing there
reads a device value back to the host, so a CUDA graph can capture it, and
nothing scatters to a shared sentinel: the compaction is a search of the
occupancy's running count, and the compacted colours come back to the
voxels by a gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def get_volume(
    images: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    grid_points: torch.Tensor,
) -> torch.Tensor:
    """Averaged nearest-pixel back-projection of ``images`` onto
    ``grid_points`` (``carving.py:63-78``), for one frame or a batch.

    One frame: images [C,H,W,ch], intrinsics [C,3,3], grid_points
    [n1,n2,n3,3] → [ch,n1,n2,n3]. A batch of B frames (the JAX callers
    ``vmap`` it): images [B,C,H,W,ch], intrinsics [C,3,3] or per frame
    [B,C,3,3], grid_points [B,n1,n2,n3,3] → [B,ch,n1,n2,n3], as one
    batched projection and gather. Extrinsics [C,4,4] are shared. The
    projection is ``project_points``' (no z clamp), in its order: the
    extrinsic product, then the intrinsic one, then ``/ (z + eps)``.
    """
    if images.dim() == 4:
        return get_volume(images[None], intrinsics, extrinsics,
                          grid_points[None])[0]
    B, C, H, W, ch = images.shape
    n1, n2, n3 = grid_points.shape[1:4]
    pts = grid_points.reshape(B, -1, 3)
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)  # [B,N,4]
    cam = torch.einsum("cij,bnj->bcni", extrinsics, pts_h)[..., :3]
    K = intrinsics.expand(B, C, 3, 3)
    pix_h = torch.einsum("bcij,bcnj->bcni", K, cam)  # [B,C,N,3]
    pix = pix_h[..., :2] / (pix_h[..., 2:3] + 1e-8)
    _, _, flat = _pixel_indices(pix, H, W)  # [B,C,N]
    sampled = torch.gather(images.reshape(B, C, H * W, ch), 2,
                           flat[..., None].expand(-1, -1, -1, ch))
    avg = sampled.mean(dim=1)  # [B,N,ch]
    return avg.transpose(1, 2).reshape(B, ch, n1, n2, n3)


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


def compact_occupied(occ: torch.Tensor, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape compaction of an occupancy mask (``carving.py:215-229``).

    Returns ``(comp [cap] int64, overflow [])``: ``comp[m]`` is the voxel id
    of the m-th occupied voxel (the first ``cap`` in voxel order; ``N``
    marks empty slots), ``overflow`` counts occupied voxels past the cap.

    The JAX function scatters each voxel id to its exclusive prefix count,
    every dropped voxel to one shared slot. Here ``comp[m]`` is found
    instead as the first voxel whose inclusive count reaches m + 1 (a
    ``searchsorted`` of the non-decreasing running count; past the last
    occupied voxel it returns N): the same ids, with no duplicate writes
    and no read-back.
    """
    N = occ.shape[0]
    count = torch.cumsum(occ.long(), 0)  # inclusive running count
    want = torch.arange(1, cap + 1, device=occ.device)
    comp = torch.searchsorted(count, want)
    return comp, torch.clamp(count[-1] - cap, min=0)


def carve_volume(
    mask: torch.Tensor,
    rgb: torch.Tensor,
    center: torch.Tensor,
    angle,
    grid: torch.Tensor,
    K_mask: Optional[torch.Tensor],
    K_color: torch.Tensor,
    extrinsics: torch.Tensor,
    volume_fill_color: float = 0.45,
    nonvisible_weight: float = 0.25,
    visibility_cap: Optional[int] = None,
    return_overflow: bool = False,
):
    """Full shape-carving forward (``carving.py:232-373``).

    Args:
        mask:   [C, H, W] silhouettes in {0, 1} (float).
        rgb:    [C, H, W, 3] images in [0, 1].
        center: [3] world-space shift for this frame.
        angle:  scalar yaw for this frame.
        grid:   [n1, n2, n3, 3] canonical voxel grid.
        K_mask: [C, 3, 3] intrinsics of the mask back-projection (the
                adaptive camera's per-frame ``temp_K``), or ``None`` to share
                ``K_color`` (one fused mask + RGB gather).
        K_color:[C, 3, 3] intrinsics of colors and visibility (always the
                cameras' own).
        extrinsics: [C, 4, 4].
        visibility_cap: if set (and below N), the visibility pair-sort runs
                on the first ``visibility_cap`` occupied voxels of the
                second threshold's set (which holds the first's). Exact when
                they fit; occupied voxels past the cap get the
                all-``nonvisible_weight`` average, as if fully occluded, and
                are counted in the overflow. ``None`` is the exact path.
        return_overflow: also return that count [] (int64).

    Returns:
        volume [4, n1, n2, n3]: ch0 occupancy, ch1:4 RGB (empty voxels get
        ``volume_fill_color``), averaged over the two carve thresholds
        (+ the overflow if requested).
    """
    C = mask.shape[0]
    n1, n2, n3 = grid.shape[:3]
    N = n1 * n2 * n3

    pts = transform_grid(grid, center, angle).reshape(-1, 3)
    imgH, imgW = rgb.shape[1], rgb.shape[2]
    pix = project_points(pts, K_color, extrinsics, clamp_z=True)  # [C,N,2]
    if K_mask is None:
        fused = torch.cat([rgb, mask[..., None]], dim=-1)  # [C,H,W,4]
        samp = sample_nearest_pixels(fused, pix)  # [C,N,4]
        sampled = samp[..., :3]
        mask_flat = samp[..., 3].mean(dim=0)  # [N]
    else:
        # The mask's own projection, without the z clamp (carving.py:302).
        sampled = sample_nearest_pixels(rgb, pix)  # [C,N,3]
        pix_m = project_points(pts, K_mask, extrinsics)
        mask_flat = sample_nearest_pixels(
            mask[..., None], pix_m)[..., 0].mean(dim=0)

    cam_pos = camera_positions(extrinsics)  # [C,3]
    occ1 = mask_flat >= 1.0
    occ2 = mask_flat >= (C - 1.0) / C
    overflow = torch.zeros((), dtype=torch.long, device=mask.device)

    def volume(occupied, colors):
        vol_rgb = torch.where(occupied[:, None], colors,
                              torch.full_like(colors, volume_fill_color))
        return torch.cat([occupied.float()[None, :], vol_rgb.T], dim=0)

    def weights_of(visible):
        weights = torch.where(visible, 1.0, nonvisible_weight)
        return weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)

    out = torch.zeros((4, N), dtype=torch.float32, device=mask.device)
    if visibility_cap is None or visibility_cap >= N:
        dists = torch.linalg.norm(pts[None] - cam_pos[:, None, :], dim=-1)
        _, _, flat = _pixel_indices(pix, imgH, imgW)
        vis1, vis2 = ray_cast_visibility_pair(dists, flat, occ1, occ2)
        for occupied, visible in ((occ1, vis1), (occ2, vis2)):
            colors = torch.einsum("cn,cnk->nk", weights_of(visible), sampled)
            out = out + volume(occupied, colors) / 2.0
    else:
        M = visibility_cap
        comp, overflow = compact_occupied(occ2, M)
        valid_c = comp < N
        # One row gather pulls the compacted voxels' positions and occ1
        # flags together; empty slots read an all-zero pad row.
        aux = torch.cat([pts, occ1[:, None].float()], dim=1)  # [N,4]
        aux = torch.cat([aux, aux.new_zeros((1, 4))], dim=0)
        aux_c = aux.index_select(0, comp)  # [M,4]
        pts_c = aux_c[:, :3]
        occ1_c = (aux_c[:, 3] > 0.5) & valid_c

        pix_c = project_points(pts_c, K_color, extrinsics, clamp_z=True)
        dists_c = torch.linalg.norm(pts_c[None] - cam_pos[:, None, :], dim=-1)
        _, _, flat_c = _pixel_indices(pix_c, imgH, imgW)
        vis1_c, vis2_c = ray_cast_visibility_pair(dists_c, flat_c, occ1_c,
                                                  valid_c)
        samp_pad = torch.cat([sampled, sampled.new_zeros((C, 1, 3))], dim=1)
        sampled_c = samp_pad.index_select(1, comp)  # [C,M,3]

        # Each voxel's slot in the compaction (M: not in it). Overflowed
        # occupied voxels, and only those, keep the uniform average, as if
        # fully occluded (carving.py:353).
        slot = torch.cumsum(occ2.long(), 0) - 1
        slot = torch.where(occ2 & (slot < M), slot, M)
        in_cap = (slot < M)[:, None]
        slot = slot.clamp(max=M - 1)
        base_colors = sampled.mean(dim=0)
        for occupied, visible_c in ((occ1, vis1_c), (occ2, vis2_c)):
            colors_c = torch.einsum("cm,cmk->mk", weights_of(visible_c),
                                    sampled_c)  # [M,3]
            colors = torch.where(in_cap, colors_c.index_select(0, slot),
                                 base_colors)
            out = out + volume(occupied, colors) / 2.0
    vol = out.reshape(4, n1, n2, n3)
    if return_overflow:
        return vol, overflow
    return vol
