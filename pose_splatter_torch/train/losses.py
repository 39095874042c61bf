"""Losses: soft IoU + masked L1 + SSIM (counterpart of
``pose_splatter_tpu/train/losses.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pose_splatter_torch.ops.ssim import ssim


def iou_loss(predicted_mask: torch.Tensor, target_mask: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Soft IoU loss, reduced over the last two axes, then meaned."""
    intersection = (predicted_mask * target_mask).sum(dim=(-2, -1))
    union = (predicted_mask + target_mask
             - predicted_mask * target_mask).sum(dim=(-2, -1))
    iou = (intersection + eps) / (union + eps)
    return 1.0 - iou.mean()


def masked_l1_loss(pred_img: torch.Tensor, target_img: torch.Tensor,
                   target_mask: torch.Tensor) -> torch.Tensor:
    """Sum of absolute error normalized by the mask area."""
    return (target_img - pred_img).abs().sum() / torch.clamp(
        target_mask.sum(), min=1.0)


def total_loss(
    rgb: torch.Tensor,
    alpha: torch.Tensor,
    target_img: torch.Tensor,
    target_mask: torch.Tensor,
    img_lambda: float,
    ssim_lambda: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """rgb [H,W,3], alpha [H,W], target_img [H,W,3], target_mask [H,W]."""
    l_iou = iou_loss(alpha, target_mask)
    l_ssim = ssim_lambda * (1.0 - ssim(rgb, target_img))
    l_img = img_lambda * masked_l1_loss(rgb, target_img, target_mask)
    total = l_iou + l_ssim + l_img
    return total, {"iou": l_iou, "ssim": l_ssim, "img": l_img, "total": total}
