"""Preprocessing pipeline CLI (counterpart of ``scripts/preprocess.py``),
one subcommand per reference script:

    python -m pose_splatter_torch.scripts.preprocess convert_cameras <input.pkl> <output.h5>
    python -m pose_splatter_torch.scripts.preprocess auto_up <config.json>
    python -m pose_splatter_torch.scripts.preprocess center_rotation <config.json> [--device cpu]
    python -m pose_splatter_torch.scripts.preprocess crop_indices <config.json> [--force] [--device cpu]
    python -m pose_splatter_torch.scripts.preprocess write_images <config.json>
    python -m pose_splatter_torch.scripts.preprocess to_zarr <config.json>
    python -m pose_splatter_torch.scripts.preprocess visual_features <config.json> [--dry_run]
        [--model_fn CKPT] [--resnet_weights PTH] [--device cpu]
    python -m pose_splatter_torch.scripts.preprocess visual_embedding <config.json>

The same subcommands and arguments as the JAX script, plus ``--device``
(default ``cuda``; it raises without a CUDA device) on every subcommand;
the device work is in ``center_rotation``, ``crop_indices`` and
``visual_features``. ``visual_features`` loads the port's checkpoint
(``train/loop.py::load_checkpoint``; default: the config's) and a
torchvision ResNet18 ``.pth`` (or ``.npz``) with ``--resnet_weights``;
its rig is the config's ``visual_features`` block (``L``, ``size``,
``fov_deg``, ``radius``, ``tile_expand``, ``instance_cap``; README).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pose_splatter_torch.config import Config


def cmd_convert_cameras(args):
    from pose_splatter_torch.preprocess.cameras import convert_camera_params

    n = convert_camera_params(args.input, args.output)
    print(f"Converted {n} cameras → {args.output}")


def cmd_auto_up(args):
    from pose_splatter_torch.preprocess.up_direction import auto_estimate_up

    config = Config(args.config)
    os.makedirs(config.project_directory, exist_ok=True)
    up = auto_estimate_up(config.camera_fn, config.vertical_lines_fn)
    print(f"Estimated up direction: {up} → {config.vertical_lines_fn}")


def cmd_center_rotation(args):
    from pose_splatter_torch.preprocess.center_rotation import (
        calculate_center_rotation,
    )

    config = Config(args.config)
    centers, _, _ = calculate_center_rotation(config, device=args.device)
    print(f"Wrote {len(centers)} frames → {config.center_rotation_fn}")


def cmd_crop_indices(args):
    from pose_splatter_torch.preprocess.crop_indices import (
        calculate_volume_sum,
        suggest_volume_idx,
    )

    config = Config(args.config)
    if args.force or not os.path.exists(config.volume_sum_fn):
        volume_sum = calculate_volume_sum(config, device=args.device)
    else:
        volume_sum = np.load(config.volume_sum_fn)
    for thresh, vi in suggest_volume_idx(volume_sum).items():
        print(f"Threshold: {thresh}")
        print(f"volume_idx: {vi}")
        print(f"n1, n2, n3: {[j - i for i, j in vi]}\n")


def cmd_write_images(args):
    from pose_splatter_torch.preprocess.write_images import write_images

    config = Config(args.config)
    out = write_images(config)
    print(f"Wrote {out}")


def cmd_to_zarr(args):
    from pose_splatter_torch.preprocess.write_images import copy_h5_to_zarr

    config = Config(args.config)
    h5_fn = os.path.join(config.image_directory, "images.h5")
    print(f"→ {copy_h5_to_zarr(h5_fn)}")


def cmd_visual_features(args):
    from pose_splatter_torch.preprocess.visual_features import (
        calculate_visual_features,
    )
    from pose_splatter_torch.train.loop import create_train_state, load_checkpoint
    from pose_splatter_torch.train.trainer import (
        build_datasets,
        build_model,
        checkpoint_path,
    )

    config = Config(args.config)
    model = build_model(config, device=args.device)
    (dset,) = build_datasets(config, splits=("all_volumes",))
    state = create_train_state(model, 1e-4)
    load_checkpoint(args.model_fn or checkpoint_path(config, False), state)
    feats = calculate_visual_features(
        config, model, dset,
        resnet_weights=args.resnet_weights, dry_run=args.dry_run,
    )
    print(f"Features: {feats.shape} → {config.feature_fn}")


def cmd_visual_embedding(args):
    from pose_splatter_torch.preprocess.visual_embedding import (
        calculate_visual_embedding,
    )

    config = Config(args.config)
    emb = calculate_visual_embedding(config)
    print(f"Embedding: {emb.shape} → {config.embedding_fn}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Preprocessing pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--device", default="cuda",
                       help="torch device of the device work (default cuda)")
        p.set_defaults(fn=fn)
        return p

    p = add("convert_cameras", cmd_convert_cameras)
    p.add_argument("input")
    p.add_argument("output")

    for name, fn in [("auto_up", cmd_auto_up),
                     ("center_rotation", cmd_center_rotation),
                     ("write_images", cmd_write_images),
                     ("to_zarr", cmd_to_zarr),
                     ("visual_embedding", cmd_visual_embedding)]:
        add(name, fn).add_argument("config")

    p = add("crop_indices", cmd_crop_indices)
    p.add_argument("config")
    p.add_argument("--force", action="store_true")

    p = add("visual_features", cmd_visual_features)
    p.add_argument("config")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--model_fn", default=None)
    p.add_argument("--resnet_weights", default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
