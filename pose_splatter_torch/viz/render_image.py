"""Novel-view rendering with pose offsets at full resolution (counterpart
of ``pose_splatter_tpu/viz/render_image.py``).

The frame's Gaussians are built (carve → U-Nets → head), yawed and shifted
to world space, turned by a user ``angle_offset`` about their centroid and
moved by ``delta_xyz``, then splatted through one camera's full-resolution
intrinsics (``K_full``, loaded at ``ds = 1``) at the full image size. In
``"kernel"`` mode on the card the splat is one launch of the forward
compositor (``csrc/composite_fwd.cu``). This is the engine of the 360°,
multiview and temporal video commands (``scripts/generate_videos.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import yaw_rotation


def render_novel_view(
    model,
    mask,
    img,
    p_3d,
    angle: float,
    view: int,
    K_full: np.ndarray,  # [C,3,3] full-resolution intrinsics
    width: int,
    height: int,
    angle_offset: float = 0.0,
    delta_xyz: Sequence[float] = (0.0, 0.0, 0.0),
    radius_clip: float = 2.0,
) -> np.ndarray:
    """Render one frame from camera ``view`` at ``width`` × ``height``.

    The centroid of the turn is the mean over all ``max_n`` slots, the
    invalid ones included (``render_image.py:56-58``); quaternions are not
    turned. 3D models only (a 2D model's Gaussians have no ``means``).
    Returns an RGB float image [height, width, 3] in [0, 1]. Marks the
    stages "carve", "unets" and "select_head" (``utils/stages.py``); the
    splat marks its own.
    """
    dev = model.device
    with torch.no_grad():
        g, _ = model.frame_gaussians(mask, img, p_3d, angle)
        means = g["means"] @ yaw_rotation(angle, dev).T + model._tensor(p_3d)
        centroid = means.mean(dim=0, keepdim=True)
        means = (means - centroid) @ yaw_rotation(angle_offset, dev).T + centroid
        means = means + model._tensor(delta_xyz)
        stages.mark("select_head", g)

        rgb, _ = model.splat(
            means,
            g["quats"],
            torch.exp(g["log_scales"]),
            torch.sigmoid(g["logit_opacities"]),
            g["colors"],
            model.viewmats[view][None],
            model._tensor(K_full)[view][None],
            width,
            height,
            valid=g["valid"],
            radius_clip=radius_clip,
        )
    model.check_selection()
    return torch.clamp(rgb[0], 0.0, 1.0).cpu().numpy()


def render_turntable(model, mask, img, p_3d, angle, view, K_full, width,
                     height, n_steps: int = 36) -> np.ndarray:
    """``n_steps`` views of a 360° yaw sweep (generate_360_rotation.py
    contract) → [n_steps, height, width, 3]."""
    frames = []
    for k in range(n_steps):
        offset = 2 * np.pi * k / n_steps
        frames.append(
            render_novel_view(model, mask, img, p_3d, angle, view, K_full,
                              width, height, angle_offset=offset))
    return np.stack(frames)
