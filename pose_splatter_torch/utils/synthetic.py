"""Synthetic multi-camera scenes (numpy, seeded): cameras on a ring and
frames of a textured ellipsoid, in memory. Used to drive the port without
a recorded dataset.
"""

from __future__ import annotations

import numpy as np

from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical


def ring_cameras(n_views: int, width: int, height: int, focal: float,
                 radius: float):
    """Cameras on a ring 60 degrees from +z, all looking at the origin."""
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    Ks = np.stack([K] * n_views).astype(np.float32)
    Es = np.stack([
        camera_extrinsic_spherical(radius, np.pi / 3, 2 * np.pi * i / n_views + 0.3)
        for i in range(n_views)]).astype(np.float32)
    return Ks, Es


def synthetic_frames(Ks, Es, height: int, width: int, crop_center, axes,
                     n_frames: int, seed: int = 0):
    """Silhouettes and colors of a textured ellipsoid (semi-axes ``axes``)
    seen by every camera, one pose per frame. In the carve grid's frame the
    ellipsoid sits at ``crop_center``; the frame's pose (yaw ``angle``,
    shift ``p_3d``) maps it to the world as the model's carve does.

    Returns mask [F,C,H,W], img [F,C,H,W,3] (white background), p_3d
    [F,3], angle [F], all float32.
    """
    rng = np.random.default_rng(seed)
    C = len(Ks)
    axes = np.asarray(axes, np.float64)
    yy, xx = np.mgrid[0:height, 0:width]
    pix = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3).astype(np.float64)
    masks = np.zeros((n_frames, C, height, width), np.float32)
    imgs = np.ones((n_frames, C, height, width, 3), np.float32)
    p_3d = rng.normal(0, 0.005, (n_frames, 3)).astype(np.float32)
    angle = rng.uniform(-0.3, 0.3, n_frames).astype(np.float32)
    for f in range(n_frames):
        c_, s_ = np.cos(angle[f]), np.sin(angle[f])
        rot = np.array([[c_, -s_, 0], [s_, c_, 0], [0, 0, 1.0]])
        center = rot @ np.asarray(crop_center, np.float64) + p_3d[f]
        for c in range(C):
            R, t = Es[c, :3, :3].astype(np.float64), Es[c, :3, 3].astype(np.float64)
            origin = -R.T @ t
            dirs = pix @ np.linalg.inv(Ks[c].astype(np.float64)).T @ R  # [P,3]
            o = (rot.T @ (origin - center)) / axes
            d = (dirs @ rot) / axes
            a = (d * d).sum(1)
            b = 2 * d @ o
            disc = b * b - 4 * a * (o @ o - 1.0)
            hit = disc > 0
            s = (-b - np.sqrt(np.where(hit, disc, 0))) / (2 * a)
            hit &= s > 0
            q = o + s[:, None] * d  # unit-sphere hit point
            col = 0.5 + 0.35 * np.stack([
                np.sin(5 * q[:, 0]), np.cos(4 * q[:, 1] + q[:, 2]), q[:, 2]], 1)
            masks[f, c] = hit.reshape(height, width)
            img = np.where(hit[:, None], np.clip(col, 0.05, 0.95), 1.0)
            imgs[f, c] = img.reshape(height, width, 3)
    return dict(mask=masks, img=imgs, p_3d=p_3d, angle=angle)


class FrameSet:
    """In-memory dataset with the interface of ``data/dataset.py``'s
    ``FrameDataset`` that ``FrameLoader`` and the evaluation read: ``get``
    (observed views only; a view drawn from ``_rng`` when none is given),
    ``observed_views``, ``split`` and ``_rng``."""

    def __init__(self, frames, observed, split: str = "train", seed: int = 0):
        self.frames = frames
        self.observed_views = np.asarray(list(observed), dtype=int)
        self.split = split
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.frames["angle"])

    def get(self, i, view_idx=None):
        fr = self.frames
        if view_idx is None:
            view_idx = int(self._rng.choice(self.observed_views))
        obs = self.observed_views
        return (fr["mask"][i, obs], fr["img"][i, obs], fr["p_3d"][i],
                float(fr["angle"][i]), view_idx)
