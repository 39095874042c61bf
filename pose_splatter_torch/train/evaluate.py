"""Evaluation: render every view of a split + per-camera image metrics
(counterpart of ``render_images`` and ``_batch_metrics`` in
``pose_splatter_tpu/train/evaluate.py``).

``dataset`` is any object with ``len()`` and ``get(i, view_idx=0) ->
(mask [C',H,W], img [C',H,W,3], p_3d [3], angle, view_idx)``, like the
JAX package's ``FrameDataset``.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from pose_splatter_torch.ops.ssim import ssim as ssim_fn


def _rendered_frames(model, dataset) -> Iterator[np.ndarray]:
    """Yield each frame's uint8 RGBA renders [C,H,W,4] over all C views."""
    view_idx = torch.arange(model.num_cameras, device=model.device)
    for i in range(len(dataset)):
        mask, img, p_3d, angle, _ = dataset.get(i, view_idx=0)
        rgb, alpha = model(mask, img, p_3d, angle, view_idx)
        rgba = torch.clamp(torch.cat([rgb, alpha[..., None]], -1), 0.0, 1.0)
        yield (255 * rgba.cpu().numpy()).astype(np.uint8)


def render_images_in_memory(model, dataset) -> np.ndarray:
    """Render every frame of ``dataset`` to all C cameras → uint8 RGBA
    [F, C, H, W, 4]."""
    return np.stack(list(_rendered_frames(model, dataset)))


def render_images(
    model,
    dataset_test,
    total_num_frames: int,
    render_fn: str,
    compression_level: int = 2,
    write_batch_frames: int = 50,
    progress: bool = True,
) -> str:
    """Render every test frame to all C cameras; write uint8 RGBA to HDF5
    (``images`` [total_num_frames, C, H, W, 4], the test split at its
    offset in the full timeline)."""
    import h5py

    C, H, W = model.num_cameras, model.H, model.W
    offset = total_num_frames - len(dataset_test)
    with h5py.File(render_fn, "w") as hdf:
        dset = hdf.create_dataset(
            "images", (total_num_frames, C, H, W, 4), dtype="uint8",
            compression="gzip", compression_opts=compression_level)
        buffer = []
        local = 0
        for rgba in _rendered_frames(model, dataset_test):
            buffer.append(rgba)
            if len(buffer) >= write_batch_frames:
                dset[offset + local: offset + local + len(buffer)] = np.array(buffer)
                local += len(buffer)
                buffer = []
                if progress:
                    print(f"  rendered {local}/{len(dataset_test)}")
        if buffer:
            dset[offset + local: offset + local + len(buffer)] = np.array(buffer)
    return render_fn


def _get_iou(pred_mask, gt_mask, eps=1e-6):
    intersection = (pred_mask * gt_mask).sum(dim=(-2, -1))
    union = (pred_mask + gt_mask - pred_mask * gt_mask).sum(dim=(-2, -1))
    return (intersection + eps) / (union + eps)


def _batch_metrics(gt_img: torch.Tensor, pred_img: torch.Tensor,
                   pred_alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    """gt/pred [b,C,h,w,3], alpha [b,C,h,w] → dict of per-camera sums [C]
    of l1, iou (α > 0.5), soft_iou, psnr and ssim."""
    mask = torch.where(gt_img[..., 0] == 1.0, 0.0, 1.0)  # [b,C,h,w]
    l1 = (gt_img - pred_img).abs().sum(dim=(-3, -2, -1)) / torch.clamp(
        mask.sum(dim=(-2, -1)), min=1.0)
    iou = _get_iou(torch.where(pred_alpha > 0.5, 1.0, 0.0), mask)
    soft_iou = _get_iou(pred_alpha, mask)
    mse = ((gt_img - pred_img) ** 2).mean(dim=(-3, -2, -1))
    psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))

    b, C = gt_img.shape[:2]
    flat_p = pred_img.reshape((-1,) + pred_img.shape[2:])
    flat_g = gt_img.reshape((-1,) + gt_img.shape[2:])
    ssim = torch.stack([ssim_fn(p, g) for p, g in zip(flat_p, flat_g)])
    ssim = ssim.reshape(b, C)
    return {
        "l1": l1.sum(dim=0),
        "iou": iou.sum(dim=0),
        "soft_iou": soft_iou.sum(dim=0),
        "psnr": psnr.sum(dim=0),
        "ssim": ssim.sum(dim=0),
    }
