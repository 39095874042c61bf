"""Render one frame from a novel view at full resolution (counterpart of
``scripts/render_image.py``).

    python -m pose_splatter_torch.scripts.render_image <config.json>
        [--frame N] [--view V] [--angle_offset RAD] [--dx X --dy Y --dz Z]
        [--output out.png] [--device cuda|cpu]

Intrinsics at ``ds = 1``, the image at the config's ``image_width`` ×
``image_height``. Needs h5py, and PIL or matplotlib for the PNG.
"""

from __future__ import annotations

import argparse
import os

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import (
    add_device,
    full_res_intrinsics,
    load_model,
    save_png,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--view", type=int, default=0)
    parser.add_argument("--angle_offset", type=float, default=0.0)
    parser.add_argument("--dx", type=float, default=0.0)
    parser.add_argument("--dy", type=float, default=0.0)
    parser.add_argument("--dz", type=float, default=0.0)
    parser.add_argument("--output", default=None)
    return add_device(parser)


def main(argv=None):
    from pose_splatter_torch.train.trainer import build_datasets
    from pose_splatter_torch.viz.render_image import render_novel_view

    args = build_parser().parse_args(argv)
    config = Config(args.config)
    K_full = full_res_intrinsics(config)
    model = load_model(config, args.device)
    (dset,) = build_datasets(config, splits=("all_volumes",))

    mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=args.view)
    rgb = render_novel_view(
        model, mask, img, p_3d, angle, args.view, K_full,
        config.image_width, config.image_height,
        angle_offset=args.angle_offset,
        delta_xyz=(args.dx, args.dy, args.dz),
    )
    out = args.output or os.path.join(
        config.project_directory, f"render_f{args.frame:04d}_v{args.view}.png")
    save_png(rgb, out)
    print(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
