"""Package outputs into a timestamped export directory (counterpart of
``scripts/organize_export.py``).

Usage: python -m pose_splatter_torch.scripts.organize_export <config.json>
    [--name LABEL]

Covers the reference's ``scripts/visualization/create_organized_export.py``:
collects checkpoints, metrics, plots, renders, and Gaussian exports from the
project directory into ``exports/<timestamp>_<label>/`` with a manifest:
the JAX script's ``CANDIDATES`` and manifest, over the port's ``Config`` and
the ``.meta.json`` beside the port's checkpoint. ``--device`` is accepted
and ignored (it runs on the host).
"""

import argparse
import datetime
import json
import os
import shutil

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device

CANDIDATES = [
    "metrics_test.csv",
    "evaluation_metrics.json",
    "loss.pdf",
    "reconstruction.pdf",
    "training_curves.pdf",
    "tsne.pdf",
    "render_grid.pdf",
    "features.npy",
    "embedding.npy",
]


def build_parser() -> argparse.ArgumentParser:
    parser = add_device(argparse.ArgumentParser(), used=False)
    parser.add_argument("config")
    parser.add_argument("--name", default="export")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = Config(args.config)

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out_dir = os.path.join(config.project_directory, "exports",
                           f"{stamp}_{args.name}")
    os.makedirs(out_dir, exist_ok=True)

    manifest = {"timestamp": stamp, "config": os.path.abspath(args.config),
                "files": []}
    shutil.copy(args.config, os.path.join(out_dir, "config.json"))
    manifest["files"].append("config.json")

    for fn in CANDIDATES:
        src = os.path.join(config.project_directory, fn)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, fn))
            manifest["files"].append(fn)

    # Checkpoint metadata (history) if present.
    from pose_splatter_torch.train.trainer import checkpoint_path

    meta = checkpoint_path(config, False) + ".meta.json"
    if os.path.exists(meta):
        shutil.copy(meta, os.path.join(out_dir, "checkpoint_meta.json"))
        manifest["files"].append("checkpoint_meta.json")

    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"Export packaged: {out_dir} ({len(manifest['files'])} files)")


if __name__ == "__main__":
    main()
