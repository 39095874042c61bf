"""Host-side video decode (a copy of ``pose_splatter_tpu/preprocess/video.py``;
OpenCV imported where it is used).

Video IO stays on the host. The reference decodes with joblib over frame
chunks (``write_images.py:165-167``); the same chunked process-parallel
pattern is kept for decode, while the carving math runs on the device in
frame batches (``center_rotation.py``, ``crop_indices.py``).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


def require_cv2():
    """The ``cv2`` module, or ImportError with what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("OpenCV (cv2) is required for video preprocessing") from e
    return cv2


def video_frame_count(video_fn: str) -> int:
    cv2 = require_cv2()
    cap = cv2.VideoCapture(video_fn)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def iter_mask_frames(
    mask_video_fns: Sequence[str],
    frame_indices: Sequence[int],
    frame_jump: int,
    downsample: int = 1,
    binarize: bool = True,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_idx, masks [C,h,w] float {0,1}) for each requested frame.

    Reads every video sequentially with ``frame_jump`` skipping, matching
    ``calculate_center_rotation.py:93-116``.
    """
    cv2 = require_cv2()
    caps = [cv2.VideoCapture(fn) for fn in mask_video_fns]
    for cap in caps:
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame_indices[0])
    try:
        for frame_idx in frame_indices:
            masks = []
            ok = True
            for cap in caps:
                ret, frame = cap.read()
                if not ret:
                    ok = False
                    break
                masks.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
                for _ in range(frame_jump - 1):
                    cap.read()
            if not ok:
                break
            m = np.array(masks).astype(np.float32) / 255.0
            if downsample != 1:
                m = m[:, ::downsample][:, :, ::downsample]
            if binarize:
                m = np.where(m > 0.5, 1.0, 0.0).astype(np.float32)
            yield frame_idx, m
    finally:
        for cap in caps:
            cap.release()


def iter_masked_rgb_frames(
    mask_video_fns: Sequence[str],
    video_fns: Sequence[str],
    frame_indices: Sequence[int],
    frame_jump: int,
    downsample: int = 1,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_idx, frames [C,h,w,3] uint8) with the background
    whited out where mask < 128 (``write_images.py:84-91``)."""
    cv2 = require_cv2()
    WHITE = 255 * np.ones(3, np.uint8)
    mask_caps = [cv2.VideoCapture(fn) for fn in mask_video_fns]
    video_caps = [cv2.VideoCapture(fn) for fn in video_fns]
    for cap in mask_caps + video_caps:
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame_indices[0])
    try:
        for frame_idx in frame_indices:
            masks, frames = [], []
            ok = True
            for mask_cap, video_cap in zip(mask_caps, video_caps):
                ret, frame = mask_cap.read()
                if not ret:
                    ok = False
                    break
                masks.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
                for _ in range(frame_jump - 1):
                    mask_cap.read()
                ret, frame = video_cap.read()
                if not ret:
                    ok = False
                    break
                frames.append(frame[..., ::-1])  # BGR → RGB
                for _ in range(frame_jump - 1):
                    video_cap.read()
            if not ok:
                break
            masks_a = np.array(masks)
            frames_a = np.array(frames)
            if downsample != 1:
                masks_a = masks_a[:, ::downsample][:, :, ::downsample]
                frames_a = frames_a[:, ::downsample][:, :, ::downsample]
            frames_a[masks_a < 128] = WHITE
            yield frame_idx, frames_a
    finally:
        for cap in mask_caps + video_caps:
            cap.release()
