"""Dataset/config utilities (counterpart of ``scripts/dataset_utils.py``).

Usage:
    python -m pose_splatter_torch.scripts.dataset_utils verify <config.json>
    python -m pose_splatter_torch.scripts.dataset_utils compare <a.json> <b.json>
    python -m pose_splatter_torch.scripts.dataset_utils update_paths \
        <config.json> --data_directory D --project_directory P
    python -m pose_splatter_torch.scripts.dataset_utils analyze <config.json>

Covers the reference's ``scripts/utils/verify_datasets.py`` (file presence +
shape/frame-count checks, incl. the frame_jump sanity check from
``train_script.py:285-316``), ``compare_configs.py`` (key-wise diff),
``update_config_paths.py`` (path migration), and ``analyze_results.py``
(training-history summary from the checkpoint metadata). The output is
the JAX script's, over the port's ``Config`` and the ``.meta.json`` beside
the port's checkpoint (``train/trainer.py::checkpoint_path``). Every
subcommand takes ``--device`` so that one command line fits every CLI of
the port; they run on the host and ignore it.
"""

import argparse
import json
import os
import sys

import numpy as np

from pose_splatter_torch.config import Config
from pose_splatter_torch.scripts.common import add_device


def cmd_verify(args):
    import h5py

    config = Config(args.config)
    ok = True

    def check(label, cond, detail=""):
        nonlocal ok
        mark = "OK " if cond else "FAIL"
        if not cond:
            ok = False
        print(f"[{mark}] {label}{(': ' + detail) if detail else ''}")

    check("camera_fn exists", os.path.exists(config.camera_fn),
          config.camera_fn)
    check("vertical_lines_fn exists", os.path.exists(config.vertical_lines_fn),
          config.vertical_lines_fn)
    cr_ok = os.path.exists(config.center_rotation_fn)
    check("center_rotation_fn exists", cr_ok, config.center_rotation_fn)

    img_fn = os.path.join(config.image_directory, "images.h5")
    img_ok = os.path.exists(img_fn)
    check("images.h5 exists", img_ok, img_fn)

    n_frames = None
    if img_ok:
        with h5py.File(img_fn, "r") as f:
            shape = f["images"].shape
            n_frames = shape[0]
            C = len(config.video_fns) if config.get("video_fns") else shape[1]
            h = config.image_height // config.image_downsample
            w = config.image_width // config.image_downsample
            check("images shape", shape[1:] == (C, h, w, 3),
                  f"{shape} vs (T,{C},{h},{w},3)")
        # frame_jump sanity (train_script.py:294-315): baseline 3600@jump=5.
        expected = int(3600 * 5.0 / config.frame_jump)
        check("frame count plausible", abs(n_frames - expected) <= 500
              or n_frames < 1000,
              f"{n_frames} frames (expected ~{expected} at "
              f"frame_jump={config.frame_jump})")

    if cr_ok and n_frames is not None:
        d = np.load(config.center_rotation_fn)
        check("centers/angles match frame count",
              len(d["centers"]) >= n_frames,
              f"{len(d['centers'])} centers vs {n_frames} frames")

    try:
        vi = config.validated_volume_idx()
        check("volume_idx div-16", True, str(vi))
    except ValueError as e:
        check("volume_idx div-16", False, str(e))

    sys.exit(0 if ok else 1)


def cmd_compare(args):
    a = Config(args.config_a)._data
    b = Config(args.config_b)._data
    keys = sorted(set(a) | set(b))
    for k in keys:
        va, vb = a.get(k, "<missing>"), b.get(k, "<missing>")
        if va != vb:
            print(f"{k}:")
            print(f"  A: {va}")
            print(f"  B: {vb}")


def cmd_update_paths(args):
    with open(args.config) as f:
        data = json.load(f)
    if args.data_directory:
        data["data_directory"] = args.data_directory
    if args.project_directory:
        data["project_directory"] = args.project_directory
    with open(args.config, "w") as f:
        json.dump(data, f, indent=4)
    print(f"Updated {args.config}")


def cmd_analyze(args):
    from pose_splatter_torch.train.trainer import checkpoint_path

    config = Config(args.config)
    meta_fn = checkpoint_path(config, False) + ".meta.json"
    if not os.path.exists(meta_fn):
        print("No checkpoint metadata found:", meta_fn)
        sys.exit(1)
    with open(meta_fn) as f:
        meta = json.load(f)
    losses = np.array(meta["losses"])  # [epochs, 3]
    names = meta.get("loss_names", ["iou", "ssim", "img"])
    print(f"Epochs trained: {len(losses)}")
    for i, name in enumerate(names):
        print(f"  {name}: first={losses[0, i]:.5f} last={losses[-1, i]:.5f} "
              f"min={losses[:, i].min():.5f}")
    total = losses.sum(axis=1)
    print(f"  total: first={total[0]:.5f} last={total[-1]:.5f} "
          f"best={total.min():.5f} (epoch {int(total.argmin()) + 1})")
    v = meta.get("validation_losses")
    if v:
        print(f"  validation: last={v[-1]:.5f} best={min(v):.5f}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = add_device(sub.add_parser("verify"), used=False)
    p.add_argument("config")
    p.set_defaults(fn=cmd_verify)
    p = add_device(sub.add_parser("compare"), used=False)
    p.add_argument("config_a")
    p.add_argument("config_b")
    p.set_defaults(fn=cmd_compare)
    p = add_device(sub.add_parser("update_paths"), used=False)
    p.add_argument("config")
    p.add_argument("--data_directory", default=None)
    p.add_argument("--project_directory", default=None)
    p.set_defaults(fn=cmd_update_paths)
    p = add_device(sub.add_parser("analyze"), used=False)
    p.add_argument("config")
    p.set_defaults(fn=cmd_analyze)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
