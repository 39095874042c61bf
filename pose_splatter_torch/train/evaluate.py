"""Evaluation: render every view of a split, per-camera image metrics,
LPIPS and the summary (counterpart of ``pose_splatter_tpu/train/
evaluate.py``).

``dataset`` is any object with ``len()`` and ``get(i, view_idx=0) ->
(mask [C',H,W], img [C',H,W,3], p_3d [3], angle, view_idx)``, like the
JAX package's ``FrameDataset``.

The metrics read their images from anything that slices to uint8
[b, C, H, W, 3 or 4] (an HDF5 dataset or a numpy array):
:func:`image_metrics` and :func:`lpips_metric` do the array work on a
device, :func:`calculate_image_metrics` and :func:`calculate_lpips_metric`
open the two ``images.h5`` files around them, as the JAX functions do.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from pose_splatter_torch.ops.ssim import ssim as ssim_fn
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.device import resolve_device

METRIC_NAMES = ("l1", "iou", "soft_iou", "ssim", "psnr")
# The adaptive camera's host hook, a unit of its own while tracing.
_ADAPTIVE = stages.Scope("adaptive")


def _rendered_frames(model, dataset) -> Iterator[np.ndarray]:
    """Yield each frame's uint8 RGBA renders [C,H,W,4] over all C views.
    An adaptive model takes each frame's ``temp_K`` and seed from its host
    hook, as its training forward did (``evaluate.py:50-90``)."""
    view_idx = torch.arange(model.num_cameras, device=model.device)
    adaptive_fn = model.make_adaptive_fn() if model.adaptive_camera else None
    for i in range(len(dataset)):
        mask, img, p_3d, angle, _ = dataset.get(i, view_idx=0)
        kw = {}
        if adaptive_fn is not None:
            with _ADAPTIVE:
                temp_K, seed = adaptive_fn(mask)
            kw = dict(K_mask=np.asarray(temp_K, np.float32),
                      carve_center=np.asarray(seed, np.float32))
        rgb, alpha = model(mask, img, p_3d, angle, view_idx, **kw)
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


def split_range(n_frames: int, split: str) -> Tuple[int, int]:
    """Frames [i1, i2) of ``split`` in a timeline of ``n_frames``: the
    thirds ``len // 3`` of ``evaluate.py:134-172``."""
    if split not in ("train", "valid", "test"):
        raise ValueError(f"unknown split {split!r}")
    a2 = n_frames // 3
    return {"train": (0, a2), "valid": (a2, 2 * a2),
            "test": (2 * a2, n_frames)}[split]


def _as_float(images, start: int, end: int, device) -> torch.Tensor:
    """uint8 frames [start:end] → float32 in [0, 1] on ``device``."""
    x = torch.as_tensor(np.asarray(images[start:end]), device=device)
    return x.to(torch.float32) / 255.0


def image_metrics(
    pred_images,
    gt_images,
    split: str = "test",
    batch_size: int = 32,
    device: Union[str, torch.device] = "cuda",
    progress: bool = False,
) -> Dict[str, np.ndarray]:
    """Per-camera means [C] of l1, iou, soft_iou, ssim and psnr over a
    split: ``pred_images`` uint8 [T, C, H, W, 4] (RGBA renders) against
    ``gt_images`` uint8 [T, C, H, W, 3+], each batch's sums taken on
    ``device`` and added in float64 on the host, then divided by the
    split's length."""
    dev = resolve_device(device)
    if tuple(pred_images.shape[:-1]) != tuple(gt_images.shape[:-1]):
        raise ValueError(f"prediction {pred_images.shape} and ground truth "
                         f"{gt_images.shape} differ")
    C = pred_images.shape[1]
    i1, i2 = split_range(len(gt_images), split)
    metrics = {k: np.zeros(C) for k in METRIC_NAMES}
    with torch.no_grad():
        for start in range(i1, i2, batch_size):
            end = min(start + batch_size, i2)
            gt = _as_float(gt_images, start, end, dev)
            pred = _as_float(pred_images, start, end, dev)
            sums = _batch_metrics(gt[..., :3], pred[..., :3], pred[..., 3])
            for k in metrics:
                metrics[k] += sums[k].cpu().numpy()
            if progress:
                print(f"  metrics: {end - i1}/{i2 - i1}")
    return {k: v / (i2 - i1) for k, v in metrics.items()}


def calculate_image_metrics(
    pred_fn: str,
    gt_fn: str,
    metrics_fn: str,
    batch_size: int = 32,
    split: str = "test",
    progress: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Per-camera metric table over a split of two ``images.h5`` files;
    writes ``metrics_fn`` (one row a camera, the sorted metric names as a
    tab-joined header, ``%.6f``) and returns the [C] arrays."""
    import h5py

    with h5py.File(pred_fn, "r") as pf, h5py.File(gt_fn, "r") as gf:
        metrics = image_metrics(pf["images"], gf["images"], split=split,
                                batch_size=batch_size, device=device,
                                progress=progress)
    sorted_keys = sorted(metrics.keys())
    data = np.column_stack([metrics[k] for k in sorted_keys])
    np.savetxt(metrics_fn, data, delimiter=",", header="\t".join(sorted_keys),
               fmt="%.6f")
    return metrics


def lpips_metric(pred_images, gt_images, lpips, split: str = "test",
                 batch_size: int = 8,
                 device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Per-camera mean LPIPS [C] over a split with ``lpips`` (from
    ``ops/lpips.py::create_lpips`` on ``device``), the images as in
    :func:`image_metrics`."""
    dev = resolve_device(device)
    C = pred_images.shape[1]
    i1, i2 = split_range(len(gt_images), split)
    total = np.zeros(C)
    for start in range(i1, i2, batch_size):
        end = min(start + batch_size, i2)
        gt = _as_float(gt_images, start, end, dev)[..., :3]
        pred = _as_float(pred_images, start, end, dev)[..., :3]
        vals = lpips(pred.reshape((-1,) + pred.shape[2:]),
                     gt.reshape((-1,) + gt.shape[2:]))
        total += vals.reshape(end - start, C).sum(dim=0).cpu().numpy()
    return total / (i2 - i1)


def calculate_lpips_metric(
    pred_fn: str,
    gt_fn: str,
    weights_path: Optional[str],
    split: str = "test",
    batch_size: int = 8,
    device: Union[str, torch.device] = "cuda",
) -> Optional[np.ndarray]:
    """Per-camera LPIPS [C] over a split of two ``images.h5`` files, or
    None when ``create_lpips`` finds no weights (the metric is optional, as
    in the reference)."""
    import h5py

    from pose_splatter_torch.ops.lpips import create_lpips

    lpips = create_lpips(weights_path, device)
    if lpips is None:
        return None
    with h5py.File(pred_fn, "r") as pf, h5py.File(gt_fn, "r") as gf:
        return lpips_metric(pf["images"], gf["images"], lpips, split=split,
                            batch_size=batch_size, device=device)


def write_evaluation_summary(metrics: Dict[str, np.ndarray], out_fn: str,
                             extra: Optional[Dict] = None) -> str:
    """Camera-averaged JSON summary (``evaluation_metrics.json``)."""
    summary = {
        k: {
            "mean": float(np.mean(v)),
            "per_camera": [float(x) for x in np.asarray(v).ravel()],
        }
        for k, v in metrics.items()
    }
    if extra:
        summary.update(extra)
    with open(out_fn, "w") as f:
        json.dump(summary, f, indent=2)
    return out_fn
