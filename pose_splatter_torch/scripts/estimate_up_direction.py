"""Interactive up-direction estimation: draw vertical lines per view
(counterpart of ``scripts/estimate_up_direction.py``).

Usage: python -m pose_splatter_torch.scripts.estimate_up_direction <config.json>

Matplotlib UI parity with the reference
(``scripts/preprocessing/estimate_up_direction.py``): for each camera the
first video frame is shown; click pairs of points along real-world vertical
edges (≥1 line per view; Enter/close to advance). Each 2D line defines a
plane through the camera center with normal ``n_world = Rᵀ Kᵀ l``; the up
direction is the least-eigenvector of ``Σ n nᵀ``
(``pose_splatter_torch.preprocess.up_direction.up_from_vertical_lines``).
Saves ``vertical_lines.npz{img_nums, lines, up}``. For the non-interactive
fallback use ``python -m pose_splatter_torch.scripts.preprocess auto_up``.
It runs on the host (numpy); ``cv2`` and ``matplotlib`` are imported where
they are used.
"""

import argparse
import os

import numpy as np

from pose_splatter_torch.config import Config
from pose_splatter_torch.preprocess.up_direction import up_from_vertical_lines
from pose_splatter_torch.scripts.common import add_device
from pose_splatter_torch.utils.cameras import get_cam_params


def collect_lines(imgs):
    import matplotlib.pyplot as plt

    all_lines = []
    for i, img in enumerate(imgs):
        lines = []
        fig, ax = plt.subplots()
        ax.imshow(img)
        ax.set_title(
            f"View {i}: click point pairs along vertical edges; close to finish"
        )
        pts = plt.ginput(n=-1, timeout=0)
        plt.close(fig)
        for j in range(0, len(pts) - 1, 2):
            lines.append((pts[j], pts[j + 1]))
        all_lines.append(lines)
    return all_lines


def build_parser() -> argparse.ArgumentParser:
    parser = add_device(argparse.ArgumentParser(description=__doc__),
                        used=False)
    parser.add_argument("config")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    import cv2

    config = Config(args.config)
    imgs = []
    for video_fn in config.video_fns:
        cap = cv2.VideoCapture(video_fn)
        ret, frame = cap.read()
        assert ret, f"cannot read {video_fn}"
        imgs.append(frame[..., ::-1])
        cap.release()

    # Un-oriented camera parameters (orientation is what we're estimating).
    K, E, _ = get_cam_params(config.camera_fn, ds=1, auto_orient=False)

    lines = collect_lines(imgs)
    up = up_from_vertical_lines(lines, K, E)
    print("Estimated up direction:", up)

    out_fn = config.vertical_lines_fn
    if out_fn.endswith(".npy"):
        out_fn = out_fn[:-4] + ".npz"
    os.makedirs(os.path.dirname(out_fn), exist_ok=True)
    np.savez(
        out_fn,
        img_nums=np.arange(len(imgs)),
        lines=np.array(
            [[(p1, p2) for (p1, p2) in l] for l in lines], dtype=object
        ),
        up=up,
        allow_pickle=True,
    )
    print("Saved:", out_fn)


if __name__ == "__main__":
    main()
