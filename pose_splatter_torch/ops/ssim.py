"""SSIM and PSNR in true float32 (counterpart of
``pose_splatter_tpu/ops/ssim.py``).

torchmetrics ``StructuralSimilarityIndexMeasure`` defaults: Gaussian window
(kernel 11, sigma 1.5), k1 = 0.01, k2 = 0.03, data_range 1, channel-wise
VALID filtering and a global mean. The JAX code forces
``Precision.HIGHEST`` because reduced-precision passes destroy the
E[x²] − μ² variance estimates; here TF32 is turned off for the filter and
for its backward (cuDNN runs float32 convolutions in TF32 by default, and a
backward runs after the forward's context has closed).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _gaussian_kernel(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    coords = (torch.arange(kernel_size, dtype=torch.float32, device=device)
              - (kernel_size - 1) / 2.0)
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)  # [k, k]


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _DepthwiseFilter(torch.autograd.Function):
    """Depthwise VALID conv2d of img [B,C,H,W] by k [C,1,kh,kw], forward and
    backward with TF32 off. Only the image carries a gradient."""

    @staticmethod
    def forward(ctx, img, k):
        ctx.save_for_backward(k)
        with _no_tf32():
            return F.conv2d(img, k, groups=img.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (k,) = ctx.saved_tensors
        with _no_tf32():
            return F.conv_transpose2d(grad, k, groups=grad.shape[1]), None


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID filter. img [B,H,W,C] → [B,H',W',C]."""
    C = img.shape[-1]
    k = kernel[None, None].expand(C, 1, *kernel.shape).contiguous()
    out = _DepthwiseFilter.apply(img.permute(0, 3, 1, 2), k)
    return out.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over a batch. pred/target: [B,H,W,C] (or [H,W,C])."""
    if pred.dim() == 3:
        pred = pred[None]
        target = target[None]
    pred = pred.float()
    target = target.float()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kernel = _gaussian_kernel(kernel_size, sigma, pred.device)

    mu_x = _filter2d(pred, kernel)
    mu_y = _filter2d(target, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d(pred * pred, kernel) - mu_xx
    sigma_yy = _filter2d(target * target, kernel) - mu_yy
    sigma_xy = _filter2d(pred * target, kernel) - mu_xy

    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return torch.mean(num / den)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
