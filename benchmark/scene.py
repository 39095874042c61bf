"""Synthetic rigs and frames, made on the device from the seed.

Cameras sit on a ring 60 degrees from +z, 0.6 from the origin, and look at
it. A frame is a textured ellipsoid in the carve grid's frame at the crop's
centre, moved by the frame's pose (yaw ``angle``, shift ``p_3d``) as the
model's carve moves its grid: its silhouette and colours seen by every
camera are found by intersecting each pixel's ray with the ellipsoid, in
float64. This is the torch form of ``utils/synthetic.py`` of the program;
``tests/test_bench_harness.py`` holds the two together at a small size.
"""

from __future__ import annotations

import math

import torch

RING_RADIUS = 0.6
RING_FOCAL = 800.0  # at a 576-pixel-wide image; scaled with the width


def ring_cameras(n_views: int, width: int, height: int, device):
    """K [C,3,3], E [C,4,4] float32: a ring of cameras 60 degrees from +z
    looking at the origin, up along -z (OpenCV convention)."""
    focal = RING_FOCAL * width / 576.0
    f64 = dict(dtype=torch.float64, device=device)
    K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], **f64)
    theta = math.pi / 3
    Es = []
    for i in range(n_views):
        phi = 2 * math.pi * i / n_views + 0.3
        C = RING_RADIUS * torch.tensor([math.sin(theta) * math.cos(phi),
                                        math.sin(theta) * math.sin(phi),
                                        math.cos(theta)], **f64)
        forward = -C / torch.linalg.norm(C)
        right = torch.linalg.cross(torch.tensor([0.0, 0.0, -1.0], **f64), forward)
        right = right / torch.linalg.norm(right)
        up = torch.linalg.cross(forward, right)
        up = up / torch.linalg.norm(up)
        R = torch.stack([right, up, forward], 1).T
        E = torch.eye(4, **f64)
        E[:3, :3] = R
        E[:3, 3] = -R @ C
        Es.append(E)
    return (K[None].expand(n_views, 3, 3).to(torch.float32).contiguous(),
            torch.stack(Es).to(torch.float32))


def draw_poses(n_frames: int, generator: torch.Generator, device):
    """p_3d [F,3] ~ N(0, 0.005) and yaw [F] ~ U(-0.3, 0.3), float32."""
    p_3d = 0.005 * torch.randn((n_frames, 3), generator=generator,
                               device=device)
    angle = (torch.rand((n_frames,), generator=generator, device=device)
             * 0.6 - 0.3)
    return p_3d.float(), angle.float()


def ellipsoid_frames(Ks, Es, height: int, width: int, crop_center, axes,
                     p_3d, angle, views):
    """Silhouettes and colours of the ellipsoid in cameras ``views``.

    Returns mask [F,V,H,W] and img [F,V,H,W,3] float32 (white background)."""
    dev = Ks.device
    f64 = dict(dtype=torch.float64, device=dev)
    axes = torch.as_tensor(axes, **f64)
    center0 = torch.as_tensor(crop_center, **f64)
    yy, xx = torch.meshgrid(torch.arange(height, **f64), torch.arange(width, **f64),
                            indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1).reshape(-1, 3)
    n_f, n_v = p_3d.shape[0], len(views)
    masks = torch.zeros((n_f, n_v, height, width), dtype=torch.float32, device=dev)
    imgs = torch.ones((n_f, n_v, height, width, 3), dtype=torch.float32, device=dev)
    rays = []
    for c in views:
        R = Es[c, :3, :3].double()
        t = Es[c, :3, 3].double()
        rays.append((-R.T @ t, pix @ torch.linalg.inv(Ks[c].double()).T @ R))
    for f in range(n_f):
        a = angle[f].double()
        c_, s_ = torch.cos(a), torch.sin(a)
        z, o = torch.zeros_like(a), torch.ones_like(a)
        rot = torch.stack([torch.stack([c_, -s_, z]), torch.stack([s_, c_, z]),
                           torch.stack([z, z, o])])
        center = rot @ center0 + p_3d[f].double()
        for v, (origin, dirs) in enumerate(rays):
            o_ = (rot.T @ (origin - center)) / axes
            d = (dirs @ rot) / axes
            qa = (d * d).sum(1)
            qb = 2 * d @ o_
            disc = qb * qb - 4 * qa * (o_ @ o_ - 1.0)
            hit = disc > 0
            s = (-qb - torch.sqrt(torch.where(hit, disc, torch.zeros_like(disc)))) / (2 * qa)
            hit = hit & (s > 0)
            q = o_ + s[:, None] * d
            col = 0.5 + 0.35 * torch.stack([torch.sin(5 * q[:, 0]),
                                            torch.cos(4 * q[:, 1] + q[:, 2]),
                                            q[:, 2]], 1)
            masks[f, v] = hit.reshape(height, width).float()
            imgs[f, v] = torch.where(hit[:, None], torch.clamp(col, 0.05, 0.95),
                                     torch.ones_like(col)).reshape(height, width, 3).float()
    return masks, imgs
