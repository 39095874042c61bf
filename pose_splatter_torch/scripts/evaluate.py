"""Evaluate a trained model: render the split and its per-camera metrics
(counterpart of ``scripts/evaluate.py``).

    python -m pose_splatter_torch.scripts.evaluate <config.json> [--ablation]
        [--split test] [--lpips_weights W] [--device cuda|cpu]

Renders all C views of each frame of the split to
``<render_directory>/rendered_images.h5``, then l1 / iou / soft_iou / psnr
/ ssim per camera → ``metrics_<split>.csv`` (and LPIPS with
``--lpips_weights``: the JAX package's ``.npz`` or a directory with
``alexnet.pth`` and ``lpips_alex.pth``) and ``evaluation_metrics.json``.
Needs h5py.
"""

from __future__ import annotations

import argparse
import os

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device, load_model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--ablation", action="store_true")
    parser.add_argument("--split", default="test",
                        choices=["train", "valid", "test"])
    parser.add_argument("--lpips_weights", default=None,
                        help="Path to LPIPS/AlexNet weights (optional)")
    return add_device(parser)


def main(argv=None):
    from pose_splatter_torch.train.evaluate import (
        calculate_image_metrics,
        calculate_lpips_metric,
        render_images,
        write_evaluation_summary,
    )
    from pose_splatter_torch.train.trainer import build_datasets

    args = build_parser().parse_args(argv)
    config = Config(args.config)
    model = load_model(config, args.device, ablation=args.ablation)
    (test_ds,) = build_datasets(config, splits=(args.split,))
    (all_ds,) = build_datasets(config, splits=("all_volumes",))

    os.makedirs(config.render_directory, exist_ok=True)
    render_fn = os.path.join(config.render_directory, "rendered_images.h5")
    render_images(model, test_ds, len(all_ds), render_fn,
                  compression_level=config.image_compression_level or 2)

    gt_fn = os.path.join(config.image_directory, "images.h5")
    metrics_fn = os.path.join(config.project_directory,
                              f"metrics_{args.split}.csv")
    metrics = calculate_image_metrics(render_fn, gt_fn, metrics_fn,
                                      split=args.split, device=args.device)
    if args.lpips_weights:
        lpips = calculate_lpips_metric(render_fn, gt_fn, args.lpips_weights,
                                       split=args.split, device=args.device)
        if lpips is not None:
            metrics["lpips"] = lpips
    summary_fn = os.path.join(config.project_directory,
                              "evaluation_metrics.json")
    write_evaluation_summary(metrics, summary_fn)
    for k, v in metrics.items():
        print(f"{k}: mean={float(v.mean()):.4f}")
    return metrics


if __name__ == "__main__":
    main()
