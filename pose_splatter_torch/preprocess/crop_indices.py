"""Volume crop-index suggestion (preprocessing step 3); counterpart of
``pose_splatter_tpu/preprocess/crop_indices.py``.

Accumulate carved-occupancy counts over ≤5000 frames, reduce to per-axis 1D
profiles, and report the smallest index range covering each threshold padded
to a multiple of 16 (``find_div_n_subarray``). The carve runs on the device
(``device``, the card by default) in frame batches, one batched tensor
computation a batch (``_occupancy_batch``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from pose_splatter_torch.ops.carving import get_volume
from pose_splatter_torch.utils.cameras import (
    adjust_principal_points_to_seed,
    get_cam_params,
)
from pose_splatter_torch.utils.device import resolve_device
from pose_splatter_torch.utils.geometry import create_3d_grid, yaw_rotation

MAX_NUM_FRAMES = 5000


def find_div_n_subarray(arr: np.ndarray, thresh: float = 1, n: int = 16) -> Tuple[int, int]:
    """Smallest [min_idx, max_idx) covering ``arr >= thresh``, padded
    symmetrically to a multiple of ``n`` and clamped into bounds."""
    assert arr.ndim == 1
    assert len(arr) % n == 0
    ones = np.where(arr >= thresh)[0]
    if len(ones) == 0:
        return 0, 0
    min_idx = int(ones[0])
    max_idx = int(ones[-1]) + 1
    rem = (max_idx - min_idx) % n
    if rem != 0:
        rem_mod_2 = (n - rem) % 2
        half_rem = (n - rem) // 2
        min_idx -= half_rem + rem_mod_2
        max_idx += half_rem
        if min_idx < 0:
            diff = -min_idx
            min_idx += diff
            max_idx += diff
        elif max_idx > len(arr):
            diff = max_idx - len(arr)
            min_idx -= diff
            max_idx -= diff
    assert (max_idx - min_idx) % n == 0
    assert min_idx >= 0 and max_idx <= len(arr)
    return min_idx, max_idx


def _occupancy_batch(masks, centers, angles, grid, Ks, Es, carve_threshold):
    """[B,C,h,w] masks (+ per-frame centre [B,3], yaw [B], and K [C,3,3] or
    per frame [B,C,3,3]) → summed binary occupancy [n,n,n] int32
    (``:60-73``). Each frame's grid is yaw-rotated, then shifted, as
    ``transform_grid`` does."""
    rot = yaw_rotation(angles, device=grid.device)  # [B,3,3]
    g = (torch.einsum("abci,nji->nabcj", grid, rot)
         + centers[:, None, None, None, :])
    vol = get_volume(masks[..., None], Ks, Es, g)[:, 0]
    return (vol >= carve_threshold).sum(dim=0, dtype=torch.int32)


def calculate_volume_sum(
    config,
    device_batch: int = 16,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Accumulate the occupancy sum over ≤MAX_NUM_FRAMES frames
    (``:76-141``) and write ``config.volume_sum_fn``."""
    from pose_splatter_torch.preprocess.video import (
        iter_mask_frames,
        video_frame_count,
    )

    dev = resolve_device(device)
    holdout = config.holdout_views
    mask_fns = [fn for i, fn in enumerate(config.mask_video_fns) if i not in holdout]
    intrinsic, extrinsic, Ps = get_cam_params(
        config.camera_fn,
        ds=config.image_downsample,
        up_fn=config.vertical_lines_fn,
        auto_orient=True,
        load_up_direction=not config.adaptive_camera,
        holdout_views=holdout,
    )
    C = len(Ps)
    d = np.load(config.center_rotation_fn)
    centers, angles = d["centers"], d["angles"]

    grid = torch.as_tensor(create_3d_grid(config.ell, config.grid_size),
                           device=dev)
    Es = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
    K_static = torch.as_tensor(intrinsic, dtype=torch.float32, device=dev)
    # Adaptive carves at the strict threshold 1.0 (crop_indices.py:129-132).
    thresh = 1.0 if config.adaptive_camera else (C - 1.0) / C

    total = min(video_frame_count(mask_fns[0]) // 3,
                MAX_NUM_FRAMES * config.frame_jump)
    frame_indices = np.arange(0, total, config.frame_jump)

    n = config.grid_size
    volume_sum = np.zeros((n, n, n), dtype=np.int64)
    buf_m, buf_c, buf_a, buf_k = [], [], [], []

    def flush():
        nonlocal volume_sum
        if not buf_m:
            return
        Ks_b = (torch.as_tensor(np.stack(buf_k), dtype=torch.float32,
                                device=dev)
                if config.adaptive_camera else K_static)
        occ = _occupancy_batch(
            torch.as_tensor(np.stack(buf_m), device=dev),
            torch.as_tensor(np.stack(buf_c), dtype=torch.float32, device=dev),
            torch.as_tensor(np.array(buf_a), dtype=torch.float32, device=dev),
            grid, Ks_b, Es, carve_threshold=thresh,
        )
        volume_sum += occ.cpu().numpy().astype(np.int64)
        buf_m.clear(); buf_c.clear(); buf_a.clear(); buf_k.clear()

    for frame_idx, masks in iter_mask_frames(
        mask_fns, frame_indices, config.frame_jump, config.image_downsample
    ):
        i = frame_idx // config.frame_jump
        if config.adaptive_camera:
            temp_K, _ = adjust_principal_points_to_seed(masks, intrinsic, extrinsic)
            buf_k.append(temp_K)
        buf_m.append(masks)
        buf_c.append(centers[i])
        buf_a.append(angles[i])
        if len(buf_m) == device_batch:
            flush()
    flush()

    np.save(config.volume_sum_fn, volume_sum)
    return volume_sum


def suggest_volume_idx(
    volume_sum: np.ndarray,
    thresholds=(1, 3, 10, 30, 100, 300, 400, 500, 1000),
    n: int = 16,
) -> Dict[int, List[Tuple[int, int]]]:
    """Candidate ``volume_idx`` per threshold (``:144-160``)."""
    out = {}
    for thresh in thresholds:
        volume_idx = []
        for i in range(3):
            i2, i3 = (i + 1) % 3, (i + 2) % 3
            idx1, idx2 = find_div_n_subarray(
                volume_sum.sum(axis=(i2, i3)).astype(np.float64), thresh=thresh, n=n
            )
            volume_idx.append((idx1, idx2))
        out[thresh] = volume_idx
    return out
