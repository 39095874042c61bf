"""Model construction from a config (``build_model`` of
``pose_splatter_tpu/train/trainer.py``). The training loop comes later."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.utils.cameras import get_cam_params


def build_model(
    config: Config,
    ablation: bool = False,
    render_mode: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    cameras: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    seed: int = 0,
) -> PoseSplatter:
    """Build the model a config describes, on ``device``.

    ``render_mode`` defaults to the config's ``render_mode`` or
    ``"kernel"``: the hand-written compositor on a CUDA device, its plain
    PyTorch version on the CPU (chosen by where the tensors lie; there is
    no fallback between the two). ``cameras`` = (intrinsics [C,3,3],
    extrinsics [C,4,4]) replaces loading ``config.camera_fn``.
    """
    if render_mode is None:
        render_mode = config.get("render_mode", "kernel")
    if cameras is None:
        intrinsic, extrinsic, _ = get_cam_params(
            config.camera_fn,
            ds=config.image_downsample,
            up_fn=config.vertical_lines_fn,
            auto_orient=True,
            load_up_direction=not config.adaptive_camera,
        )
    else:
        intrinsic, extrinsic = cameras
    if config.adaptive_camera:
        raise NotImplementedError("adaptive_camera is not ported yet")
    return PoseSplatter(
        intrinsics=intrinsic,
        extrinsics=extrinsic,
        W=config.render_width,
        H=config.render_height,
        ell=config.ell,
        grid_size=config.grid_size,
        volume_idx=config.validated_volume_idx(),
        ablation=ablation,
        volume_fill_color=config.volume_fill_color,
        holdout_views=config.holdout_views,
        gaussian_mode=config.gaussian_mode,
        gaussian_config=config.gaussian_config,
        render_mode=render_mode,
        min_n=config.get("min_n", 1024),
        max_n=config.get("max_n", 16000),
        num_unets=config.get("num_unets", 3),
        base_filters=config.get("base_filters", 8),
        device=device,
        seed=seed,
    )
