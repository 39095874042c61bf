"""Data time against step time at the north-star shape (counterpart of
``scripts/dbg_input_pipeline.py``).

Usage:
    python -m pose_splatter_torch.scripts.dbg_input_pipeline [--frames 48]
        [--steps 30] [--workers 4] [--device cuda|cpu] [--out report.json]

Builds an on-disk uint8 dataset (``images.h5`` [T,C,H,W,3] and
``center_rotation.npz``, the reference's format: a white background and a
textured disc a view, seed 0), then measures (:func:`measure`):

1. loader only: ``FrameLoader`` with ``--workers`` threads reading and
   decoding every batch;
2. step only: the eager ``make_train_step`` (Adam 1e-3 with optax's
   defaults, ``init_means2d_center``) on one batch staged on the device;
3. overlapped: the trainer's loop, the loader feeding the step.

Prints one JSON object with the JAX script's keys plus ``decode``, the
route of the loader's decode (``data/native.py::route()``). The pipeline
is input-bound, by the JAX rule, when the overlapped step takes more than
1.15 × the step alone. ``backend`` is the torch device type; with ``--out``
on a CUDA device the file also holds ``card`` (``nvidia-smi``'s name and
power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pose_splatter_torch.utils.device import resolve_device

C, H, W, GRID = 6, 512, 576, 128
CROP = "16,112,24,104,32,96"
STEP_REPS = 5


def make_frames(T):
    """T uint8 frames [C,H,W,3], one at a time: a white background and a
    textured disc a view, from seed 0 (the decode's cost is what matters
    here, not the scene)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    disc = ((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 5) ** 2
    for _ in range(T):
        frame = np.full((C, H, W, 3), 255, np.uint8)
        tex = (rng.integers(0, 200, (C, H, W, 3))).astype(np.uint8)
        frame[:, disc] = tex[:, disc]
        yield frame


def make_poses(T):
    """The probe's ``center_rotation.npz`` arrays: every pose at the origin."""
    return dict(centers=np.zeros((T, 3), np.float32),
                angles=np.zeros((T,), np.float32),
                covs=np.zeros((T, 3, 3), np.float32))


def build_dataset(root, T):
    """``images.h5`` (:func:`make_frames`) and ``center_rotation.npz`` of T
    frames under ``root``. Returns their paths."""
    import h5py

    img_fn = os.path.join(root, "images.h5")
    with h5py.File(img_fn, "w") as f:
        d = f.create_dataset("images", (T, C, H, W, 3), dtype="u1",
                             chunks=(1, 1, H, W, 3))
        for t, frame in enumerate(make_frames(T)):
            d[t] = frame
    np.savez(os.path.join(root, "center_rotation.npz"), **make_poses(T))
    return img_fn, os.path.join(root, "center_rotation.npz")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(ds, steps: int, workers: int, device) -> dict:
    """The three measurements on dataset ``ds`` (a ``FrameDataset`` or
    anything with its interface, split "train", C views of which the last
    is held out): ms a batch of the loader alone, of the step alone and of
    the two overlapped."""
    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.scripts.synthetic_benchmark import build_model
    from pose_splatter_torch.train.loop import (
        create_train_state,
        make_train_step,
    )

    loader = FrameLoader(ds, batch_size=1, shuffle=True, workers=workers)

    # 1. loader only: drain batches, no device work.
    n = 0
    t0 = time.perf_counter()
    for _ in loader:
        n += 1
        if n >= steps:
            break
    data_ms = (time.perf_counter() - t0) / n * 1e3

    model = build_model(C, H, W, GRID, "2d", crop=CROP, device=device)
    state = create_train_state(model, 1e-3)
    init_means2d_center(model.net, W, H)
    step = make_train_step(model, state.optimizer, img_lambda=0.5,
                           ssim_lambda=0.1)

    def staged(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    # 2. step only, on one batch staged on the device.
    batch = staged(next(iter(loader)))
    state, metrics = step(state, batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        state, metrics = step(state, batch)
    float(metrics["total"])
    step_ms = (time.perf_counter() - t0) / STEP_REPS * 1e3

    # 3. overlapped: the trainer's loop (the loader feeds the step).
    n = 0
    t0 = time.perf_counter()
    for b in loader:
        state, metrics = step(state, staged(b))
        n += 1
        if n >= steps:
            break
    float(metrics["total"])
    overlapped_ms = (time.perf_counter() - t0) / n * 1e3
    return dict(data_ms=data_ms, step_ms=step_ms, overlapped_ms=overlapped_ms)


def make_report(m: dict, workers: int, device) -> dict:
    """The JAX script's report of :func:`measure`'s result ``m``, plus the
    decode's route."""
    from pose_splatter_torch.data import native

    return dict(
        config=f"{W}x{H} grid{GRID} 2d C{C} crop({CROP})",
        workers=workers,
        data_ms_per_batch=round(m["data_ms"], 2),
        step_ms=round(m["step_ms"], 2),
        overlapped_ms=round(m["overlapped_ms"], 2),
        input_bound=bool(m["overlapped_ms"] > 1.15 * m["step_ms"]),
        backend=torch.device(device).type,
        decode=native.route(),
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=48)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from pose_splatter_torch.data.dataset import FrameDataset

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        img_fn, ang_fn = build_dataset(root, args.frames)
        print(f"dataset built in {time.perf_counter()-t0:.1f}s",
              file=sys.stderr)
        ds = FrameDataset(img_fn, ang_fn, C, holdout_views=[C - 1],
                          split="train")
        m = measure(ds, args.steps, args.workers, device)

    report = make_report(m, args.workers, device)
    print(json.dumps(report, indent=2))
    if args.out:
        from pose_splatter_torch.scripts.common import write_report

        write_report(report, args.out, device)
    return report


if __name__ == "__main__":
    main()
