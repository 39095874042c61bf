"""Per-frame center + yaw estimation (preprocessing step 2); counterpart of
``pose_splatter_tpu/preprocess/center_rotation.py``.

Per frame: binarized masks → rough 3D center (weighted-median
triangulation, or the adaptive camera's principal-point seed) → binary carve
at ``(C-1)/C`` on an ``ell_tracking`` grid → volume-weighted mean and
covariance; then ``track_principal_axes`` (OT sign continuity) → yaw angles,
saved as ``center_rotation.npz{centers, angles, covs}``.

Video decode stays on the host. The carve and the moments run on the device
(``device``, the card by default) in frame batches, as one batched tensor
computation over the batch (``_carve_moments_batch``, which the JAX package
``vmap``s): the projection and the gather are ``ops/carving.py::get_volume``.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from pose_splatter_torch.ops.carving import get_volume
from pose_splatter_torch.tracking import track_principal_axes
from pose_splatter_torch.utils.cameras import (
    adjust_principal_points_to_seed,
    get_cam_params,
    get_rough_center_3d,
)
from pose_splatter_torch.utils.device import resolve_device
from pose_splatter_torch.utils.geometry import create_3d_grid


def mean_and_covariance_3d(volume: torch.Tensor, coords: torch.Tensor):
    """Volume-weighted spatial mean and covariance (``:37-49``).

    volume [..., n1, n2, n3] nonnegative; coords [..., n1, n2, n3, 3] →
    (mean [..., 3], cov [..., 3, 3]); leading dimensions are frames.

    Every grid sum is a ``torch.sum`` reduction (a tree on the card,
    cascades on the CPU). The JAX function's einsum for the covariance,
    run in torch as a [3, N] x [N, 3] product, put the card's and the
    CPU's covariances 3.5e-5 of their size apart on a 112³ grid.
    """
    total = torch.clamp(volume.sum(dim=(-3, -2, -1), keepdim=True), min=1e-12)
    weights = volume / total
    mean = (coords * weights[..., None]).sum(dim=(-4, -3, -2))
    centered = coords - mean[..., None, None, None, :]
    weighted = centered * weights[..., None]
    cov = (weighted[..., :, None] * centered[..., None, :]).sum(dim=(-5, -4, -3))
    return mean, cov


def _carve_moments_batch(
    masks: torch.Tensor,    # [B, C, h, w]
    centers: torch.Tensor,  # [B, 3] rough shifts
    grid: torch.Tensor,     # [n, n, n, 3]
    Ks: torch.Tensor,       # [C, 3, 3], or [B, C, 3, 3] when adaptive
    Es: torch.Tensor,       # [C, 4, 4]
    carve_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched binary carve + moments (``:52-71``) → (means [B,3], covs
    [B,3,3])."""
    g = grid[None] + centers[:, None, None, None, :]  # [B,n,n,n,3]
    vol = get_volume(masks[..., None], Ks, Es, g)[:, 0]  # [B,n,n,n]
    binary = (vol >= carve_threshold).to(torch.float32)
    return mean_and_covariance_3d(binary, g)


def calculate_center_rotation(
    config,
    device_batch: int = 16,
    progress: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full step-2 pipeline (``:74-155``). Returns (centers [T,3], angles
    [T], covs [T,3,3]) and writes ``config.center_rotation_fn``."""
    from pose_splatter_torch.preprocess.video import (
        iter_mask_frames,
        video_frame_count,
    )

    dev = resolve_device(device)
    holdout = config.holdout_views
    mask_fns = [
        fn for i, fn in enumerate(config.mask_video_fns) if i not in holdout
    ]
    intrinsic, extrinsic, Ps = get_cam_params(
        config.camera_fn,
        ds=config.image_downsample,
        auto_orient=True,
        load_up_direction=not config.adaptive_camera,
        up_fn=config.vertical_lines_fn,
    )
    obs = np.array([i for i in range(len(Ps)) if i not in holdout], dtype=int)
    intrinsic, extrinsic, Ps = intrinsic[obs], extrinsic[obs], Ps[obs]
    C = len(Ps)

    grid = torch.as_tensor(create_3d_grid(config.ell_tracking,
                                          config.grid_size), device=dev)
    Es = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
    K_static = torch.as_tensor(intrinsic, dtype=torch.float32, device=dev)
    thresh = (C - 1.0) / C

    total = video_frame_count(mask_fns[0])
    frame_indices = np.arange(0, total, config.frame_jump)

    centers_out, covs_out = [], []
    buf_masks, buf_centers, buf_Ks = [], [], []

    def flush():
        if not buf_masks:
            return
        masks_b = torch.as_tensor(np.stack(buf_masks), device=dev)
        centers_b = torch.as_tensor(np.stack(buf_centers),
                                    dtype=torch.float32, device=dev)
        if config.adaptive_camera:
            Ks_b = torch.as_tensor(np.stack(buf_Ks), dtype=torch.float32,
                                   device=dev)
        else:
            Ks_b = K_static
        means, covs = _carve_moments_batch(masks_b, centers_b, grid, Ks_b,
                                           Es, carve_threshold=thresh)
        centers_out.append(means.cpu().numpy())
        covs_out.append(covs.cpu().numpy())
        buf_masks.clear()
        buf_centers.clear()
        buf_Ks.clear()

    it = iter_mask_frames(
        mask_fns, frame_indices, config.frame_jump, config.image_downsample
    )
    for i, (frame_idx, masks) in enumerate(it):
        if config.adaptive_camera:
            temp_K, p_3d = adjust_principal_points_to_seed(
                masks, intrinsic, extrinsic
            )
            buf_Ks.append(temp_K)
        else:
            p_3d = get_rough_center_3d(masks, Ps)
        buf_masks.append(masks)
        buf_centers.append(p_3d)
        if len(buf_masks) == device_batch:
            flush()
            if progress and (i + 1) % (device_batch * 8) == 0:
                print(f"  center/rotation: {i + 1}/{len(frame_indices)} frames")
    flush()

    centers = np.concatenate(centers_out)
    covs = np.concatenate(covs_out)
    axes = track_principal_axes(centers, covs)
    angles = np.angle(axes[:, 0] + 1j * axes[:, 1])

    np.savez(config.center_rotation_fn, centers=centers, angles=angles, covs=covs)
    return centers, angles, covs
