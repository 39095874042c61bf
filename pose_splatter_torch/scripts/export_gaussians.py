"""Export Gaussian parameters for external viewers (counterpart of
``scripts/export_gaussians.py``).

    python -m pose_splatter_torch.scripts.export_gaussians <config.json>
        --frame N [--format npz|ply_extended|json|ply] [--output_dir DIR]
        [--device cuda|cpu]
    python -m pose_splatter_torch.scripts.export_gaussians <config.json>
        --start 0 --end 100 [--format npz] [--output_dir DIR]   # a sequence

The reference's on-disk formats (``viz/export.py``). Needs h5py.
"""

from __future__ import annotations

import argparse
import os

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device, load_model
from pose_splatter_torch.viz.export import EXTENSIONS, SAVERS


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--frame", type=int, default=None)
    parser.add_argument("--start", type=int, default=None)
    parser.add_argument("--end", type=int, default=None)
    parser.add_argument("--format", default="npz", choices=list(SAVERS))
    parser.add_argument("--output_dir", default=None)
    return add_device(parser)


def main(argv=None):
    from pose_splatter_torch.train.trainer import build_datasets
    from pose_splatter_torch.viz.export import (
        export_animation_sequence,
        extract_world_gaussians,
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.frame is None and (args.start is None or args.end is None):
        parser.error("give --frame or --start/--end")
    config = Config(args.config)
    model = load_model(config, args.device)
    (dset,) = build_datasets(config, splits=("all_volumes",))

    out_dir = args.output_dir or os.path.join(config.project_directory,
                                              "exports")
    os.makedirs(out_dir, exist_ok=True)
    if args.frame is not None:
        mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=0)
        g = extract_world_gaussians(model, mask, img, p_3d, angle)
        fn = os.path.join(
            out_dir, f"gaussian_frame{args.frame:04d}.{EXTENSIONS[args.format]}")
        SAVERS[args.format](g, fn)
        print(f"Exported {len(g['means'])} Gaussians → {fn}")
        return [fn]
    paths = export_animation_sequence(model, dset, range(args.start, args.end),
                                      out_dir, format_type=args.format)
    print(f"Exported {len(paths)} frames → {out_dir}")
    return paths


if __name__ == "__main__":
    main()
