"""Serving a recording: one held-out view of every frame, delivered to the
host as uint8 images.

Parameters (the cell's workload file): ``poses``, the distinct frames
staged on the device before the window and cycled; ``view``, the camera
rendered; ``warmup_frames``; ``sample_share``, the share of the frames
after set-up whose images are kept for the comparison (drawn from the
seed; the first is always kept). Weights: ``benchmark/weights.py``.

The loop is the program's sequence loop (``scripts/temporal_benchmark.py``
``run_sequence``) without disk and PNGs: each frame's eval forward
(``PoseSplatter.forward``) renders to uint8 on the card, and the image is
fetched one frame behind the render, an asynchronous copy into one of two
pinned buffers and an event, so the fetch overlaps the next frame's
forward. A frame's latency runs from the call that issues its render to
the moment its image is on the host.

``correct``: the kept frames, as the float image the forward returned and
as the uint8 image the host received, against the reference's rendering
of the same frames from the same weights (``benchmark/compare.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, counts, program
from benchmark.reference import train as reference
from benchmark.reference.model import Spec


def to_u8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)


class Session:
    kind = "render"

    def __init__(self, cell, seed: int, device):
        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        t0 = time.perf_counter()
        self.spec = Spec(cell.config)
        self.view = int(w["view"])
        self.inputs = program.Inputs(self.spec, seed, int(w["poses"]), device)
        t1 = time.perf_counter()
        self.model = program.build(cell.config, self.inputs)
        t2 = time.perf_counter()
        self.n_poses = int(w["poses"])
        self.share = float(w["sample_share"])
        self.rng = np.random.default_rng(seed + program.SCHEDULE_STREAM)
        self.cuda = torch.device(device).type == "cuda"
        self.bufs = self.events = None
        self.i = 0
        self.pending = None
        self.kept = []  # (pose, uint8 image on the host, float image)
        self.latencies = []
        self.attempted = self.failed = 0
        self.flops_per_unit = counts.model_flops(self.spec, train=False)
        for _ in range(int(w["warmup_frames"])):
            self.unit()
        self.finish()
        print(f"set-up: inputs {t1 - t0:.3f} s, model {t2 - t1:.3f} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", flush=True)
        self.kept = []
        self.latencies.clear()
        self.attempted = self.failed = 0

    def _render(self, pose: int):
        inp = self.inputs
        rgb, _ = self.model(inp.mask[pose], inp.img[pose], inp.p_3d[pose],
                            inp.angle[pose], self.view)
        return rgb[0], to_u8(rgb[0])

    def _start_fetch(self, u8):
        if not self.cuda:
            return u8, None
        if self.bufs is None:
            self.bufs = [torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
                         for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        buf, ev = self.bufs[self.i % 2], self.events[self.i % 2]
        buf.copy_(u8, non_blocking=True)
        ev.record()
        return buf, ev

    def _wait(self):
        pose, t_issue, rgb, (host, ev) = self.pending
        if ev is not None:
            ev.synchronize()
        self.latencies.append(time.perf_counter() - t_issue)
        if rgb is not None:
            self.kept.append((pose, host.numpy().copy(), rgb))
        self.pending = None

    def unit(self):
        """Issue frame i's render and fetch, then finish frame i - 1's."""
        pose = self.i % self.n_poses
        # Drawn from the seed; the first frame after set-up is always kept.
        keep = bool(self.rng.random() < self.share) or not self.kept
        t_issue = time.perf_counter()
        self.attempted += 1
        try:
            rgb, u8 = self._render(pose)
            staged = self._start_fetch(u8)
        except RuntimeError:
            self.failed += 1
            return
        if self.pending is not None:
            self._wait()
        # A kept frame keeps its float image on the device too.
        self.pending = (pose, t_issue, rgb.clone() if keep else None, staged)
        self.i += 1

    def finish(self):
        if self.pending is not None:
            self._wait()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
        self.finish()
        elapsed = time.perf_counter() - t0
        lat = np.asarray(self.latencies) * 1e3
        return {"render_frames_per_s": len(lat) / elapsed,
                "render_frame_ms_p95": float(np.percentile(lat, 95))}

    def release(self):
        self.cameras = self.inputs.cameras()
        poses = sorted({k[0] for k in self.kept})
        self.ref_frames = {p: {k: v.clone() for k, v in self.inputs.frame(p).items()}
                           for p in poses}
        del self.model
        self.inputs.mask = self.inputs.img = None
        self.bufs = self.events = None
        program.free_cuda()

    def reference(self) -> dict:
        """pose -> the reference's float image of each kept frame's pose."""
        weights = self.inputs.weights()
        poses = sorted(self.ref_frames)
        rgbs = reference.render_frames(weights, self.spec, self.cameras,
                                       self.inputs.grid,
                                       [self.ref_frames[p] for p in poses],
                                       self.view)
        return dict(zip(poses, rgbs))

    def check(self) -> dict:
        return compare.render_checks(self.kept, self.reference(),
                                     self.cell.workload["limits"])
