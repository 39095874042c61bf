"""What the port's user CLIs share: the ``--device`` flag, a trained model
from a config's checkpoint, full-resolution intrinsics, PNG output and the
benchmarks' report files with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional

import numpy as np


def add_device(parser: argparse.ArgumentParser,
               used: bool = True) -> argparse.ArgumentParser:
    """Add ``--device``. Every CLI of the port takes it, so that one command
    line fits them all; a host-only command (``used`` False) says in its
    help that it ignores the flag."""
    if used:
        help = ("torch device (default cuda; it raises without a CUDA "
                "device, pass cpu for the plain path)")
    else:
        help = "ignored: this command runs on the host only"
    parser.add_argument("--device", default="cuda", help=help)
    return parser


def load_model(config, device, ablation: bool = False,
               required: bool = True):
    """The config's model on ``device`` with the weights of its checkpoint
    (``create_train_state`` + ``load_checkpoint``). With ``required``
    False a missing checkpoint leaves the seeded weights and says so."""
    import sys

    from pose_splatter_torch.train.loop import create_train_state, load_checkpoint
    from pose_splatter_torch.train.trainer import build_model, checkpoint_path

    model = build_model(config, ablation=ablation, device=device)
    state = create_train_state(model, 1e-4)
    try:
        load_checkpoint(checkpoint_path(config, ablation), state)
    except FileNotFoundError:
        if required:
            raise
        print("(no checkpoint found; profiling with random weights)",
              file=sys.stderr)
    return model


def full_res_intrinsics(config) -> np.ndarray:
    """[C,3,3] intrinsics at ``ds = 1`` (``render_image.py:25-44``)."""
    from pose_splatter_torch.utils.cameras import get_cam_params

    K_full, _, _ = get_cam_params(
        config.camera_fn, ds=1, up_fn=config.vertical_lines_fn,
        auto_orient=True, load_up_direction=not config.adaptive_camera)
    return K_full


def save_png(rgb: np.ndarray, fn: str) -> None:
    """An RGB float image in [0, 1] as an 8-bit PNG (PIL, else
    matplotlib)."""
    try:
        from PIL import Image

        Image.fromarray((rgb * 255).astype(np.uint8)).save(fn)
    except ImportError:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt

        plt.imsave(fn, rgb)


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.stdout.strip().splitlines()[0]


def write_report(report: dict, path: str, device) -> None:
    """``report`` as JSON at ``path``, with the card's line when ``device``
    (a ``torch.device`` or its name) is CUDA."""
    import torch

    out = dict(report)
    if torch.device(device).type == "cuda":
        out["card"] = card_line()
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
