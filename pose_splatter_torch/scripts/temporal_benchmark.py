"""Temporal-sequence render benchmark (counterpart of
``scripts/temporal_benchmark.py``; BASELINE.json ``configs[3]``).

Usage:
    python -m pose_splatter_torch.scripts.synthetic_benchmark ... \\
        --save-state state.pt
    python -m pose_splatter_torch.scripts.temporal_benchmark --state state.pt \\
        [--length 3600] [--end-to-end] [--disk-frames 360] \\
        [--lpips-weights W] [--keep-frames DIR] [--device cuda|cpu] \\
        [--out TEMPORAL.json]

Renders a ``--length``-frame sequence through the whole eval forward
(carve → U-Nets → Gaussian heads → render) of the model that
``synthetic_benchmark.py --save-state`` saved, and reports frames/s and ms
a frame, with the held-out PSNR / SSIM / IoU of the scene's unique poses
against its oracle. Every frame renders to uint8 on the device
(``clamp(rgb·255 + 0.5, 0, 255)``, truncated) and is fetched to the host
one frame behind the render: an asynchronous copy into a pinned buffer and
an event, so the fetch overlaps the next frame's forward.

Two modes, as the JAX script's:

- default: each frame's inputs are staged on the device before the timed
  loop; the fetch is the only boundary paid;
- ``--end-to-end``: frames come off disk, ``images.h5`` and
  ``center_rotation.npz`` in the reference layout read through
  ``FrameDataset`` (split "all", 2 reader threads, 4 frames ahead) and its
  decode (``data/native.py``); every render is written as a PNG by 2
  writer threads (``compress_level=1``); one ffmpeg MP4 mux at the end when
  ``ffmpeg`` exists.

LPIPS is reported only with ``--lpips-weights`` (else null with the JAX
script's gate). The report has the JAX script's keys plus ``decode``: the
route that made the timed renders' inputs (``"numpy"``: the staged
payloads, ``frames / 255`` as in the JAX script; in the end-to-end mode
``data/native.py::route()``). ``backend`` is the torch device type. With
``--out`` on a CUDA device the file also holds ``card``, the card's name
and power limit from ``nvidia-smi``.

The timed loop is :func:`run_sequence`, which takes the render, the reader
and the writer as functions, so a caller can drive it with the readers and
writers its machine has.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from pose_splatter_torch.scripts import synthetic_benchmark as sb
from pose_splatter_torch.scripts.common import write_report
from pose_splatter_torch.utils.device import resolve_device

LPIPS_GATE = "no weights supplied (zero-egress image ships none)"
READERS, READ_AHEAD, WRITERS = 2, 4, 2


def load_state(path: str, device):
    """The model that ``synthetic_benchmark --save-state`` trained, rebuilt
    on ``device`` with its weights, and the scene's settings."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    sc = saved["scene"]
    C = sc["cameras"]
    model = sb.build_model(
        C, sc["height"], sc["width"], sc["grid"], sc["mode"], crop=sc["crop"],
        holdout=C - 1, anchored=sc.get("anchored", False),
        min_n=sc.get("min_n", 512), max_n=sc.get("max_n", 8192),
        device=device)
    model.net.load_state_dict({**saved["params"], **saved["batch_stats"]})
    return model, sc


def to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """An image in [0, 1] as the PNG writer's uint8, on its device."""
    return torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)


def make_render_u8(model, holdout: int):
    """(mask, img, p_3d, angle) → the held-out view as uint8 [H,W,3] on the
    model's device."""

    def render_u8(mask, img, p_3d, angle):
        rgb, _ = model(mask, img, p_3d, angle, holdout)
        return to_u8(rgb[0])

    return render_u8


class _Fetch:
    """The host fetch one frame behind the render: the uint8 image goes
    into one of two pinned buffers by an asynchronous copy and an event;
    :meth:`wait` returns it on the host once its copy is done. On the CPU
    the render is already on the host."""

    def __init__(self):
        self.bufs, self.events = None, None

    def start(self, i: int, u8: torch.Tensor):
        if u8.device.type != "cuda":
            return u8, None
        if self.bufs is None:
            self.bufs = [torch.empty(u8.shape, dtype=u8.dtype,
                                     pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        buf, ev = self.bufs[i % 2], self.events[i % 2]
        buf.copy_(u8, non_blocking=True)
        ev.record()
        return buf, ev

    @staticmethod
    def wait(staged) -> np.ndarray:
        host, ev = staged
        if ev is not None:
            ev.synchronize()
        return host.numpy()


def run_sequence(render_u8: Callable, read: Callable[[int], tuple],
                 length: int,
                 write: Optional[Callable[[int, np.ndarray], None]] = None
                 ) -> float:
    """Render frames 0 … ``length`` − 1 and return the seconds it took.

    ``read(i)`` gives frame i's render arguments; READERS threads call it
    up to READ_AHEAD frames ahead. ``render_u8(*args)`` returns the uint8
    image on the device; it is fetched to the host one frame behind the
    render (the fetch of frame i waits only for frame i's copy, while frame
    i + 1's forward is queued). ``write(i, image)``, where given, runs in
    WRITERS threads on a copy of the fetched image, and every write has
    finished when this returns."""
    fetch = _Fetch()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(READERS) as readpool, \
            ThreadPoolExecutor(WRITERS) as writepool:
        reads = {i: readpool.submit(read, i)
                 for i in range(min(READ_AHEAD, length))}
        writes = []

        def finish(i, staged):
            image = fetch.wait(staged)
            if write is not None:
                writes.append(writepool.submit(write, i, image.copy()))

        pending = None
        for i in range(length):
            args = reads.pop(i).result()
            if i + READ_AHEAD < length:
                reads[i + READ_AHEAD] = readpool.submit(read, i + READ_AHEAD)
            staged = fetch.start(i, render_u8(*args))
            if pending is not None:
                finish(*pending)
            pending = (i, staged)
        if pending is not None:
            finish(*pending)
        for w in writes:
            w.result()
    return time.perf_counter() - t0


def quality(model, frames, centers, angles, holdout: int,
            lpips_weights: Optional[str] = None):
    """Held-out PSNR, SSIM and IoU (α > 0.5) of every unique pose against
    the oracle (``synthetic_benchmark.evaluate``), unrounded means, and the
    LPIPS mean with its gate (None and the gate string without weights)."""
    imgs = frames.astype(np.float32) / 255.0
    masks = np.where(imgs[..., 0] == 1.0, 0.0, 1.0).astype(np.float32)
    psnrs, ssims, ious, _ = sb.evaluate(model, masks, imgs, centers, angles,
                                        holdout, False)
    out = dict(psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)),
               iou=float(np.mean(ious)), lpips=None, lpips_gate=LPIPS_GATE)
    if lpips_weights:
        from pose_splatter_torch.ops.lpips import create_lpips

        lpips = create_lpips(lpips_weights, device=model.device)
        if lpips is not None:
            obs = model.observed_views
            vals = []
            with torch.no_grad():
                for t in range(len(frames)):
                    rgb, _ = model(masks[t][obs], imgs[t][obs], centers[t],
                                   angles[t], holdout)
                    target = model._tensor(imgs[t][holdout])
                    vals.append(float(lpips(rgb[:1], target[None])[0]))
            out.update(lpips=round(float(np.mean(vals)), 4), lpips_gate=None)
    return out


def staged_reader(model, frames, centers, angles):
    """read(i) over frame i mod T's inputs, staged on the model's device
    once (the default mode's payloads)."""
    imgs = frames.astype(np.float32) / 255.0
    masks = np.where(imgs[..., 0] == 1.0, 0.0, 1.0).astype(np.float32)
    obs = model.observed_views
    t = model._tensor
    payload = [(t(masks[i][obs]), t(imgs[i][obs]), t(centers[i]),
                t(angles[i])) for i in range(len(frames))]
    return lambda i: payload[i % len(payload)]


def dataset_reader(ds, D: int, device):
    """read(i) through ``ds.get((i mod D)·C, view_idx=0)``: split "all"
    enumerates frame × view, so a stride of C visits each frame once (the
    render target is the held-out view). The arrays go to ``device`` in the
    reader's thread."""
    def read(i):
        m, im, p, a, _ = ds.get((i % D) * ds.C, view_idx=0)
        return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                     for x in (m, im, p, a))

    return read


def write_disk_dataset(root: str, frames, centers, angles, D: int):
    """``images.h5`` [D,C,H,W,3] uint8 (the unique poses repeated, one chunk
    a view) and ``center_rotation.npz`` in the reference layout; returns
    their paths."""
    import h5py

    T, C, H, W, _ = frames.shape
    img_fn = os.path.join(root, "images.h5")
    with h5py.File(img_fn, "w") as f:
        d = f.create_dataset("images", (D, C, H, W, 3), dtype="u1",
                             chunks=(1, 1, H, W, 3))
        for t in range(D):
            d[t] = frames[t % T]
    reps = -(-D // T)
    cr_fn = os.path.join(root, "center_rotation.npz")
    np.savez(cr_fn,
             centers=np.concatenate([centers] * reps)[:D].astype(np.float32),
             angles=np.concatenate([angles] * reps)[:D].astype(np.float32),
             covs=np.zeros((D, 3, 3), np.float32))
    return img_fn, cr_fn


def png_writer(frames_dir: str):
    """write(i, uint8 [H,W,3]) → ``frame_{i:05d}.png`` at compress_level 1
    (deflate level 6 is about 4x slower for files about 15 % smaller)."""
    from PIL import Image

    def write(i, rgb_u8):
        Image.fromarray(rgb_u8).save(
            os.path.join(frames_dir, f"frame_{i:05d}.png"), compress_level=1)

    return write


def mux(frames_dir: str, mp4: str) -> Optional[float]:
    """One ffmpeg MP4 mux of the PNGs when ``ffmpeg`` exists; its seconds,
    else None."""
    if not shutil.which("ffmpeg"):
        return None
    t1 = time.perf_counter()
    subprocess.run(
        ["ffmpeg", "-y", "-framerate", "30", "-pattern_type", "glob",
         "-i", os.path.join(frames_dir, "*.png"), "-c:v", "libx264",
         "-pix_fmt", "yuv420p", mp4], check=False, capture_output=True)
    return round(time.perf_counter() - t1, 2)


def make_report(sc: dict, mode: str, length: int, elapsed: float,
                mux_s: Optional[float], q: dict, device, decode: str) -> dict:
    """The JAX script's report, plus ``decode``: ``sc`` the scene's
    settings, ``q`` :func:`quality`'s result, ``elapsed`` the seconds of
    :func:`run_sequence`."""
    return {
        "config": (f"{sc['width']}x{sc['height']} grid{sc['grid']} "
                   f"{sc['mode']} C{sc['cameras']}"),
        "mode": mode,
        "sequence_frames": length,
        "render_time_s": round(elapsed, 2),
        "frames_per_s": round(length / elapsed, 2),
        "ms_per_frame": round(elapsed / length * 1e3, 2),
        "mp4_mux_s": mux_s,
        "holdout_psnr_db": round(q["psnr"], 2),
        "holdout_ssim": round(q["ssim"], 4),
        "holdout_iou": round(q["iou"], 4),
        "lpips": q["lpips"],
        "lpips_gate": q["lpips_gate"],
        "backend": torch.device(device).type,
        "decode": decode,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--state", required=True,
                        help="torch.save file from synthetic_benchmark "
                        "--save-state")
    parser.add_argument("--length", type=int, default=3600)
    parser.add_argument("--end-to-end", action="store_true",
                        help="pay the real boundaries: disk reads via "
                        "FrameDataset + PNG export pool + optional MP4 mux")
    parser.add_argument("--disk-frames", type=int, default=360,
                        help="rows written to the on-disk images.h5 the "
                        "end-to-end sequence cycles over")
    parser.add_argument("--lpips-weights", default=None,
                        help="converted LPIPS weights (.npz); absent → "
                        "metric gated, recorded as null")
    parser.add_argument("--keep-frames", default=None,
                        help="keep PNG frames + MP4 in this directory "
                        "(default: temp dir, deleted)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model, sc = load_state(args.state, device)
    C, W, H, g = sc["cameras"], sc["width"], sc["height"], sc["grid"]
    holdout = C - 1
    print(f"Scene: {C} cameras, {W}x{H}, grid {g}, mode {sc['mode']}, "
          f"{sc['frames']} unique poses", file=sys.stderr)
    _, _, frames, centers, angles = sb.make_scene(
        C, H, W, T=sc["frames"],
        radii=tuple(sc.get("radii", (0.10, 0.05, 0.04))))

    # The quality pass is also the warm-up (kernel builds, cuDNN's
    # choices) before the timed sequence.
    q = quality(model, frames, centers, angles, holdout, args.lpips_weights)
    render_u8 = make_render_u8(model, holdout)
    mux_s = None
    if args.end_to_end:
        from pose_splatter_torch.data import native
        from pose_splatter_torch.data.dataset import FrameDataset

        mode_tag = ("disk reads (FrameDataset/images.h5) + PNG writer pool"
                    + (" + mp4" if shutil.which("ffmpeg") else
                       " (ffmpeg absent: no mp4)"))
        root = args.keep_frames or tempfile.mkdtemp(prefix="temporal_")
        frames_dir = os.path.join(root, "frames")
        os.makedirs(frames_dir, exist_ok=True)
        D = args.disk_frames
        img_fn, cr_fn = write_disk_dataset(root, frames, centers, angles, D)
        ds = FrameDataset(img_fn, cr_fn, C, holdout_views=[holdout],
                          split="all")
        decode = native.route()
        elapsed = run_sequence(render_u8, dataset_reader(ds, D, device),
                               args.length, png_writer(frames_dir))
        mux_s = mux(frames_dir, os.path.join(root, "sequence.mp4"))
        if not args.keep_frames:
            shutil.rmtree(root, ignore_errors=True)
    else:
        mode_tag, decode = "pre-staged device payloads", "numpy"
        elapsed = run_sequence(
            render_u8, staged_reader(model, frames, centers, angles),
            args.length)

    report = make_report(sc, mode_tag, args.length, elapsed, mux_s, q,
                         device, decode)
    print(json.dumps(report, indent=2))
    if args.out:
        write_report(report, args.out, device)
    return report


if __name__ == "__main__":
    main()
