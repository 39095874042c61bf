"""Preprocessing: videos → center/rotation → crop indices → images.h5 →
visual-pose features and embedding (counterpart of
``pose_splatter_tpu/preprocess``; ``scripts/preprocess.py`` drives it)."""

from pose_splatter_torch.preprocess.cameras import convert_camera_params  # noqa: F401
from pose_splatter_torch.preprocess.up_direction import (  # noqa: F401
    auto_estimate_up,
    up_from_vertical_lines,
)
