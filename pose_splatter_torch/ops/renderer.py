"""Object-style renderer facade over the functional rasterizers
(counterpart of ``pose_splatter_tpu/ops/renderer.py``).

An abstract ``GaussianRenderer`` with ``get_num_params()`` /
``render(params, viewmat, K)`` and a case-insensitive
``create_renderer(mode, width, height, **kwargs)`` factory that forwards its
keyword arguments. The ``[N, P]`` parameter layouts are the reference's (14
for 3D, 9 for 2D), as are the activations (exp scales, clamped colours,
sigmoid opacity). The 3D renderer defaults to ``"tiled"`` mode, the 2D one
to ``"global"``, as in the JAX package.

The functional API (:mod:`pose_splatter_torch.ops.rasterize`) stays the
primary interface; renders run on the device of the parameters.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import torch

from pose_splatter_torch.ops.rasterize import rasterize, rasterize_2d


class GaussianRenderer(ABC):
    """Abstract base: width/height/background + render()."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.background_color = torch.zeros(3)

    @abstractmethod
    def get_num_params(self) -> int:
        ...

    @abstractmethod
    def render(self, gaussian_params: torch.Tensor, viewmat: torch.Tensor,
               K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, P] params + [4,4] viewmat + [3,3] K → (rgb [H,W,3], alpha [H,W])."""
        ...

    def set_background_color(self, color) -> None:
        color = torch.as_tensor(color, dtype=torch.float32)
        if color.shape != (3,):
            raise ValueError(f"Expected color shape (3,), got {tuple(color.shape)}")
        self.background_color = color

    def _check(self, gaussian_params: torch.Tensor) -> torch.Tensor:
        n = self.get_num_params()
        if gaussian_params.shape[1] != n:
            raise ValueError(f"Expected {n} parameters per Gaussian, got "
                             f"{gaussian_params.shape[1]}")
        return self.background_color.to(gaussian_params.device)


class GaussianRenderer3D(GaussianRenderer):
    """14 params/Gaussian: means(3) + log_scales(3) + quats(4) + colors(3)
    + logit opacity(1)."""

    def __init__(self, width: int, height: int,
                 render_mode: str = "tiled", **kwargs):
        super().__init__(width, height)
        self.mode = render_mode

    def get_num_params(self) -> int:
        return 14

    def render(self, gaussian_params, viewmat, K):
        bg = self._check(gaussian_params)
        means = gaussian_params[:, 0:3]
        log_scales = gaussian_params[:, 3:6]
        quats = gaussian_params[:, 6:10]
        colors = torch.clamp(gaussian_params[:, 10:13], 0.0, 1.0)
        opac = torch.sigmoid(gaussian_params[:, 13])
        rgb, alpha = rasterize(
            means, quats, torch.exp(log_scales), opac, colors,
            viewmat[None], K[None], self.width, self.height,
            backgrounds=bg, mode=self.mode)
        return rgb[0], alpha[0]


class GaussianRenderer2D(GaussianRenderer):
    """9 params/Gaussian: means_2d(2) + log_scales_2d(2) + rotation(1)
    + colors(3) + logit opacity(1). viewmat/K accepted but unused."""

    def __init__(self, width: int, height: int, kernel_size: int = 5,
                 sigma_cutoff: float = 3.0, batch_size: int = 1,
                 render_mode: str = "global", **kwargs):
        super().__init__(width, height)
        self.kernel_size = kernel_size
        self.sigma_cutoff = sigma_cutoff
        self.batch_size = batch_size  # accepted for config parity; unused
        self.mode = render_mode

    def get_num_params(self) -> int:
        return 9

    def render(self, gaussian_params, viewmat=None, K=None):
        bg = self._check(gaussian_params)
        means2d = gaussian_params[:, 0:2]
        scales2d = torch.exp(gaussian_params[:, 2:4])
        rotation = gaussian_params[:, 4]
        colors = torch.clamp(gaussian_params[:, 5:8], 0.0, 1.0)
        opac = torch.sigmoid(gaussian_params[:, 8])
        return rasterize_2d(
            means2d, scales2d, rotation, opac, colors, self.width,
            self.height, background=bg, sigma_cutoff=self.sigma_cutoff,
            mode=self.mode)


def create_renderer(mode: str, width: int, height: int,
                    **kwargs) -> GaussianRenderer:
    """Factory (case-insensitive): ``"2d"`` or ``"3d"``."""
    mode_l = mode.lower()
    if mode_l == "2d":
        return GaussianRenderer2D(width, height, **kwargs)
    if mode_l == "3d":
        return GaussianRenderer3D(width, height, **kwargs)
    raise ValueError(f"Unknown renderer mode: '{mode}'. Expected '2d' or '3d'.")
