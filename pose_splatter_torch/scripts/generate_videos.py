"""Video and multiview renders (counterpart of ``scripts/generate_videos.py``).

    python -m pose_splatter_torch.scripts.generate_videos 360 <config.json>
        --frame N [--view V] [--steps 36] [--device cuda|cpu]
    python -m pose_splatter_torch.scripts.generate_videos multiview <config.json> --frame N
    python -m pose_splatter_torch.scripts.generate_videos temporal <config.json>
        --start A --end B [--view V]

Each frame is a full-resolution novel view (``viz/render_image.py``),
written as a PNG into ``<project>/video_<mode>/``; ``360`` and
``temporal`` then run ffmpeg once when it is on ``PATH`` and otherwise
leave the PNGs. Needs h5py, and PIL or matplotlib.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import (
    add_device,
    full_res_intrinsics,
    load_model,
    save_png,
)


def _ffmpeg(frames_dir, out_mp4, fps=10):
    if shutil.which("ffmpeg") is None:
        print("ffmpeg not found; PNG frames left in", frames_dir)
        return
    subprocess.run(
        ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
         "-i", os.path.join(frames_dir, "*.png"),
         "-c:v", "libx264", "-pix_fmt", "yuv420p", out_mp4],
        check=False, capture_output=True)
    print("Wrote", out_mp4)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["360", "multiview", "temporal"])
    parser.add_argument("config")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--view", type=int, default=0)
    parser.add_argument("--steps", type=int, default=36)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=100)
    parser.add_argument("--fps", type=int, default=10)
    return add_device(parser)


def main(argv=None):
    from pose_splatter_torch.train.trainer import build_datasets
    from pose_splatter_torch.viz.render_image import render_novel_view

    args = build_parser().parse_args(argv)
    config = Config(args.config)
    model = load_model(config, args.device)
    (dset,) = build_datasets(config, splits=("all_volumes",))
    K_full = full_res_intrinsics(config)
    W, H = config.image_width, config.image_height

    out_dir = os.path.join(config.project_directory, f"video_{args.mode}")
    os.makedirs(out_dir, exist_ok=True)

    if args.mode == "360":
        mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=args.view)
        for k in range(args.steps):
            rgb = render_novel_view(
                model, mask, img, p_3d, angle, args.view, K_full, W, H,
                angle_offset=2 * np.pi * k / args.steps)
            save_png(rgb, os.path.join(out_dir, f"rot_{k:03d}.png"))
        _ffmpeg(out_dir, os.path.join(config.project_directory,
                                      f"rotation_f{args.frame:04d}.mp4"),
                args.fps)
    elif args.mode == "multiview":
        mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=0)
        for v in range(model.num_cameras):
            rgb = render_novel_view(model, mask, img, p_3d, angle, v, K_full,
                                    W, H)
            save_png(rgb, os.path.join(out_dir, f"view_{v}.png"))
        print("Wrote", out_dir)
    else:  # temporal
        for frame in range(args.start, args.end):
            mask, img, p_3d, angle, _ = dset.get(frame, view_idx=args.view)
            rgb = render_novel_view(model, mask, img, p_3d, angle, args.view,
                                    K_full, W, H)
            save_png(rgb, os.path.join(out_dir, f"frame_{frame:05d}.png"))
        _ffmpeg(out_dir, os.path.join(config.project_directory,
                                      "temporal.mp4"), args.fps)
    return out_dir


if __name__ == "__main__":
    main()
