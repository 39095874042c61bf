"""Profile the PoseSplatter pipeline stage by stage (counterpart of
``scripts/profile.py``).

    python -m pose_splatter_torch.scripts.profile synthetic [--grid 64]
        [--width 576] [--height 512] [--mode 3d] [--trace DIR] [--device cuda|cpu]
    python -m pose_splatter_torch.scripts.profile config <config.json>
        [--frame N] [--trace DIR] [--device cuda|cpu]

Prints a JSON stage-timing report (``utils/profiling.py::profile_model``:
carve / U-Nets / extraction / render / full forward / full forward and
backward, Mpix/s, steps/s). The synthetic model renders in ``"kernel"``
mode on the card and ``"tiled"`` on the CPU, as the JAX script picks
``"pallas"`` on the TPU and ``"tiled"`` elsewhere. ``--trace`` also writes
a ``torch.profiler`` trace of one eval forward into DIR.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pose_splatter_torch.scripts.common import add_device


def synthetic(args):
    from pose_splatter_torch.models.pose_splatter import PoseSplatter
    from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical

    C = 4
    W, H = args.width, args.height
    f = 1.6 * max(W, H)
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C, np.float32)
    Es = np.stack([
        camera_extrinsic_spherical(1.0, np.pi / 2.5, 2 * np.pi / C * i)
        for i in range(C)
    ]).astype(np.float32)
    g = args.grid
    vi = [[0, g], [0, g], [0, g]]
    on_cpu = torch.device(args.device).type == "cpu"
    model = PoseSplatter(Ks, Es, W, H, ell=0.3, grid_size=g, volume_idx=vi,
                         gaussian_mode=args.mode,
                         render_mode="tiled" if on_cpu else "kernel",
                         device=args.device)
    yy, xx = np.mgrid[0:H, 0:W]
    m = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 5) ** 2).astype(np.float32)
    mask = np.stack([m] * C)
    img = np.stack([np.stack([m * 0.7, m * 0.3, m * 0.5], -1)] * C)
    return model, mask, img, np.zeros(3, np.float32), 0.2


def from_config(args):
    from pose_splatter_torch.config import Config
    from pose_splatter_torch.scripts.common import load_model
    from pose_splatter_torch.train.trainer import build_datasets

    config = Config(args.config)
    model = load_model(config, args.device, required=False)
    (dset,) = build_datasets(config, splits=("all_volumes",))
    mask, img, p_3d, angle, _ = dset.get(args.frame, view_idx=0)
    return model, mask, img, p_3d, angle


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = add_device(sub.add_parser("synthetic"))
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--width", type=int, default=576)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--mode", default="3d", choices=["2d", "3d"])
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=synthetic)
    p = add_device(sub.add_parser("config"))
    p.add_argument("config")
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=from_config)
    return parser


def main(argv=None):
    from pose_splatter_torch.utils.profiling import profile_model, trace

    args = build_parser().parse_args(argv)
    model, mask, img, p_3d, angle = args.fn(args)
    report = profile_model(model, mask, img, p_3d, angle)
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in report.items()}, indent=2))

    if args.trace:
        with trace(args.trace):
            model(mask, img, p_3d, angle, 0)
        print(f"trace written to {args.trace}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
