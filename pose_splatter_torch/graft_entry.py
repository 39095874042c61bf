"""Single-device entry point (counterpart of ``__graft_entry__.py::entry``):
the flagship 3D ``PoseSplatter`` forward, carve → U-Nets → Gaussian head →
tiled rasterize, on a small model.

    fn, example_args = entry()          # on the card
    rgb, alpha = fn(*example_args)

Not ported yet: ``dryrun_multichip`` (ROADMAP.md A.10).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical


def _build_model(grid_size: int = 32, H: int = 64, W: int = 64, C: int = 3,
                 render_mode: str = "tiled",
                 device: Union[str, torch.device] = "cuda"):
    """The JAX entry's model (``__graft_entry__.py:6-28``): C cameras on a
    ring at radius 1.5, f = 80, ell 0.6, 2 U-Nets of width 8, 3D Gaussians
    (64 to 1024), ``tile_shape`` (32, 64); with a disc mask and a tinted
    image per camera. Returns (model, masks [C,H,W], imgs [C,H,W,3])."""
    f = 80.0
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C, np.float32)
    Es = np.stack([
        camera_extrinsic_spherical(1.5, np.pi / 3, 2 * np.pi * i / C)
        for i in range(C)
    ]).astype(np.float32)
    model = PoseSplatter(
        Ks, Es, W, H,
        ell=0.6, grid_size=grid_size, min_n=64, max_n=1024,
        volume_idx=[[0, grid_size]] * 3, num_unets=2, base_filters=8,
        gaussian_mode="3d", render_mode=render_mode, tile_shape=(32, 64),
        device=device,
    )
    yy, xx = np.mgrid[0:H, 0:W]
    mask = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 4) ** 2).astype(np.float32)
    masks = np.stack([mask] * C)
    imgs = np.stack([np.stack([mask * 0.8, mask * 0.2, mask * 0.5], -1)] * C)
    return model, masks, imgs


def entry(device: Union[str, torch.device] = "cuda"):
    """Returns ``(fn, example_args)``. ``fn(variables, mask, img, p_3d,
    angle, view_idx)`` is the model's eval forward and returns (rgb
    [1,H,W,3], alpha [1,H,W]); ``variables`` is the net's parameters and
    buffers by name (a state dict of ``model.net``), applied with
    ``torch.func.functional_call``, so that the weights are an argument as
    in JAX."""
    model, masks, imgs = _build_model(device=device)
    dev = model.device
    variables = {k: v.detach().clone() for k, v in
                 list(model.net.named_parameters())
                 + list(model.net.named_buffers())}

    def fn(variables, mask, img, p_3d, angle, view_idx):
        bound = {f"net.{k}": v for k, v in variables.items()}
        return torch.func.functional_call(
            model, bound, (mask, img, p_3d, angle, view_idx))

    example_args = (
        variables,
        torch.as_tensor(masks, device=dev),
        torch.as_tensor(imgs, device=dev),
        torch.zeros(3, device=dev),
        torch.tensor(0.3, device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
    return fn, example_args
