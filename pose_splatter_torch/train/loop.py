"""Eval step (the eval half of ``pose_splatter_tpu/train/loop.py``).

Training, the optimizer and checkpoints come in a later change.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from pose_splatter_torch.train.losses import total_loss


def _forward_loss(model, frame: Dict, img_lambda: float,
                  ssim_lambda: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eval forward + loss for one frame (``loop.py:48-73`` with
    ``train=False``): renders ``frame["view_idx"]`` and compares it with
    observed view ``frame["obs_idx"]``. The count of Gaussian×tile
    instances dropped by finite binning capacity rides along in the
    metrics (zero in healthy runs)."""
    mask = model._tensor(frame["mask"])
    img = model._tensor(frame["img"])
    rgb, alpha, overflow = model(mask, img, frame["p_3d"], frame["angle"],
                                 frame["view_idx"], return_overflow=True)
    obs = int(frame["obs_idx"])
    loss, metrics = total_loss(rgb[0], alpha[0], img[obs], mask[obs],
                               img_lambda, ssim_lambda)
    return loss, dict(metrics, overflow=overflow.float())


def make_eval_step(model, img_lambda: float, ssim_lambda: float
                   ) -> Callable[[Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Validation-loss step over a frame batch (``loop.py:205-226``), with
    the model's running BN statistics.

    Batch entries carry a leading frame axis B: mask [B,C',H,W],
    img [B,C',H,W,3], p_3d [B,3], angle [B], view_idx [B], obs_idx [B].
    Returns the loss and the metrics, each meaned over the frames.
    """

    @torch.no_grad()
    def eval_step(batch: Dict):
        losses, metrics = [], []
        for b in range(len(batch["angle"])):
            loss, m = _forward_loss(model, {k: v[b] for k, v in batch.items()},
                                    img_lambda, ssim_lambda)
            losses.append(loss)
            metrics.append(m)
        mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        return torch.stack(losses).mean(), mean

    return eval_step
