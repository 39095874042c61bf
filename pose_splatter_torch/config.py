"""JSON configuration system (a copy of ``pose_splatter_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package.
The same JSON key names are understood, path-valued keys are joined onto
``data_directory`` / ``project_directory``, defaults match, and
``validated_volume_idx`` enforces the U-Net's div-16 constraint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

# Keys whose values are file names inside ``data_directory`` (lists).
DATA_LIST_ATTRIBUTES = ["mask_video_fns", "video_fns"]

# Keys whose values are paths inside ``project_directory``.
PROJECT_ATTRIBUTES = [
    "volume_directory",
    "image_directory",
    "render_directory",
    "camera_fn",
    "vertical_lines_fn",
    "center_rotation_fn",
    "volume_sum_fn",
    "model_fn",
    "feature_fn",
    "embedding_fn",
]

# Full schema (reference ``config_utils.py:11-48``) plus framework additions.
ATTRIBUTES = [
    "data_directory",
    "project_directory",
    "mask_video_fns",
    "video_fns",
    "holdout_views",
    "volume_directory",
    "image_directory",
    "render_directory",
    "image_compression_level",
    "volume_compression_level",
    "camera_fn",
    "vertical_lines_fn",
    "center_rotation_fn",
    "volume_sum_fn",
    "model_fn",
    "feature_fn",
    "embedding_fn",
    "image_width",
    "image_height",
    "image_downsample",
    "adaptive_camera",
    "fps",
    "train_time",
    "valid_time",
    "ell",
    "ell_tracking",
    "grid_size",
    "frame_jump",
    "max_frames",
    "volume_idx",
    "volume_fill_color",
    "img_lambda",
    "ssim_lambda",
    "lr",
    "valid_every",
    "plot_every",
    "save_every",
    "gaussian_mode",
    "gaussian_config",
    # The visual-pose feature rig (``preprocess/visual_features.py``).
    "visual_features",
]

_DEFAULTS: Dict[str, Any] = {
    "holdout_views": [],
    "image_downsample": 1,
    "adaptive_camera": False,
    "volume_fill_color": 0.45,
    "img_lambda": 0.5,
    "ssim_lambda": 0.0,
    "lr": 1e-4,
    "valid_every": 5,
    "plot_every": 5,
    "save_every": 10,
    "gaussian_mode": "3d",
    "gaussian_config": {},
    "visual_features": {},
    "max_frames": None,
    "frame_jump": 1,
}


class Config:
    """Attribute-style access to a JSON config with directory-prefix logic."""

    def __init__(self, source: Any):
        if isinstance(source, (str, os.PathLike)):
            with open(source, "r") as f:
                self._data = json.load(f)
        elif isinstance(source, dict):
            self._data = dict(source)
        else:
            raise TypeError(f"Config source must be a path or dict, got {type(source)}")

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        data = object.__getattribute__(self, "_data")
        if name in DATA_LIST_ATTRIBUTES:
            if name in data:
                data_dir = data.get("data_directory", "")
                return [os.path.join(data_dir, i) for i in data[name]]
        elif name in PROJECT_ATTRIBUTES:
            if name in data:
                proj_dir = data.get("project_directory", "")
                return os.path.join(proj_dir, data[name])
        if name in data:
            return data[name]
        if name in _DEFAULTS:
            return _DEFAULTS[name]
        raise AttributeError(f"'Config' object has no attribute '{name}'")

    def get(self, name: str, default: Any = None) -> Any:
        try:
            return getattr(self, name)
        except AttributeError:
            return default

    # ------------------------------------------------------------------
    def to_serializable(self) -> Dict[str, Any]:
        """Plain dict snapshot (for multiprocess workers), as the reference's
        ``Config.to_serializable`` (``config_utils.py:95-103``)."""
        result = {}
        for attr in ATTRIBUTES:
            try:
                result[attr] = getattr(self, attr)
            except AttributeError:
                result[attr] = None
        return result

    # ------------------------------------------------------------------
    @property
    def render_width(self) -> int:
        return self.image_width // self.image_downsample

    @property
    def render_height(self) -> int:
        return self.image_height // self.image_downsample

    def validated_volume_idx(self) -> List[List[int]]:
        """``volume_idx`` clipped to the grid and validated for the U-Net's
        div-16 constraint (reference ``unet_3d.py:89-91``; the reference's
        ``debug_quick.json`` violates this — see SURVEY.md §5.6)."""
        vi = self.volume_idx
        n = self.grid_size
        out = []
        for (i1, i2) in vi:
            i1c, i2c = max(0, min(i1, n)), max(0, min(i2, n))
            out.append([i1c, i2c])
        for (i1, i2) in out:
            if (i2 - i1) % 16 != 0:
                raise ValueError(
                    f"volume_idx {vi} with grid_size {n} yields extent "
                    f"{i2 - i1}, not divisible by 16 (U-Net constraint)."
                )
        return out
