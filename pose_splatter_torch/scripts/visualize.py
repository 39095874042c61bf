"""Visualisation helpers (counterpart of ``scripts/visualize.py``).

    python -m pose_splatter_torch.scripts.visualize gaussians <exported.npz> [--output g.pdf]
    python -m pose_splatter_torch.scripts.visualize voxels <config.json> [--frame N] [--device cuda|cpu]
    python -m pose_splatter_torch.scripts.visualize training <config.json>
    python -m pose_splatter_torch.scripts.visualize renders <config.json> [--num 5]
    python -m pose_splatter_torch.scripts.visualize ellipses <config.json> [--num 200]

A 3D scatter of exported Gaussians, a carved frame's occupancy, the loss
curves of a checkpoint's history, ground truth beside the evaluation's
renders, and the body Gaussian's per-frame ellipses from
``center_rotation.npz``. Needs matplotlib; ``voxels`` and ``renders`` also
h5py. Only ``voxels`` uses the device; the others take ``--device`` and
their help says that they ignore it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device


def cmd_gaussians(args):
    from pose_splatter_torch.viz.plots import plot_gaussian_scatter

    d = np.load(args.path, allow_pickle=True)
    g = {k: d[k] for k in ("means", "colors")}
    out = args.output or os.path.splitext(args.path)[0] + ".pdf"
    print("Saved", plot_gaussian_scatter(g, out))
    return out


def cmd_voxels(args):
    from pose_splatter_torch.train.trainer import build_datasets, build_model
    from pose_splatter_torch.viz.plots import plot_voxels

    config = Config(args.config)
    model = build_model(config, device=args.device)
    (dset,) = build_datasets(config, splits=("all_volumes",))
    mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=0)
    vol = model.carve(mask, img, p_3d, angle)
    out = os.path.join(config.project_directory, "voxels.pdf")
    print("Saved", plot_voxels(vol[0].cpu().numpy(), out))
    return out


def cmd_ellipses(args):
    from pose_splatter_torch.viz.plots import plot_ellipses

    config = Config(args.config)
    d = np.load(config.center_rotation_fn)
    if "covs" not in d:
        raise SystemExit("center_rotation.npz has no 'covs' — rerun "
                         "the preprocess script's center_rotation")
    n = min(len(d["centers"]), args.num)
    out = os.path.join(config.project_directory, "ellipses.pdf")
    print("Saved", plot_ellipses(d["centers"][:n], d["covs"][:n], out))
    return out


def cmd_training(args):
    from pose_splatter_torch.train.trainer import checkpoint_path
    from pose_splatter_torch.viz.plots import plot_losses

    config = Config(args.config)
    with open(checkpoint_path(config, False) + ".meta.json") as f:
        meta = json.load(f)
    out = os.path.join(config.project_directory, "training_curves.pdf")
    print("Saved", plot_losses(meta["losses"], meta.get("validation_losses"),
                               config.valid_every, out))
    return out


def cmd_renders(args):
    import h5py

    from pose_splatter_torch.viz.plots import _plt

    plt = _plt()
    config = Config(args.config)
    gt_fn = os.path.join(config.image_directory, "images.h5")
    pred_fn = os.path.join(config.render_directory, "rendered_images.h5")
    with h5py.File(gt_fn, "r") as gf, h5py.File(pred_fn, "r") as pf:
        T = len(gf["images"])
        i1 = 2 * (T // 3)  # test split start
        idxs = np.linspace(i1, T - 1, args.num, dtype=int)
        _, axarr = plt.subplots(nrows=args.num, ncols=2,
                                figsize=(5, 2.2 * args.num))
        for row, idx in enumerate(idxs):
            axarr[row, 0].imshow(gf["images"][idx][0])
            axarr[row, 1].imshow(pf["images"][idx][0][..., :3])
            for ax in axarr[row]:
                ax.axis("off")
        axarr[0, 0].set_title("Ground Truth")
        axarr[0, 1].set_title("Render")
    out = os.path.join(config.project_directory, "render_grid.pdf")
    plt.tight_layout()
    plt.savefig(out)
    plt.close("all")
    print("Saved", out)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        p = add_device(sub.add_parser(name), used=name == "voxels")
        p.set_defaults(fn=fn)
        return p

    p = add("gaussians", cmd_gaussians)
    p.add_argument("path")
    p.add_argument("--output", default=None)

    p = add("voxels", cmd_voxels)
    p.add_argument("config")
    p.add_argument("--frame", type=int, default=0)

    add("training", cmd_training).add_argument("config")

    p = add("ellipses", cmd_ellipses)
    p.add_argument("config")
    p.add_argument("--num", type=int, default=200)

    p = add("renders", cmd_renders)
    p.add_argument("config")
    p.add_argument("--num", type=int, default=5)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
