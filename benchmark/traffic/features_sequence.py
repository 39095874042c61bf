"""The visual-pose feature stage over a recording: each frame's spherical
rig render, ResNet-18 features and their spherical-harmonic power,
delivered to the host as float16.

Parameters (the cell's workload file): ``poses``, the distinct frames
staged on the device before the window and cycled; ``warmup_frames``;
``sample_share``, the share of the frames after set-up whose features are
kept for the comparison (drawn from the seed; the first is always kept).
The rig is the configuration's ``visual_features`` block. Weights: the
model's from ``benchmark/weights.py``, ResNet-18's from
``benchmark/resnet.py``, one dict each for both sides.

The loop is the program's ``calculate_visual_features`` without disk: a
frame's yaw theta ~ U[0, 2 pi) drawn from the seed, the program's frame
function (``make_frame_features``: carve, U-Nets, selection and head, the
rig's one batched render, ResNet-18, |A f|), then a blocking fetch of the
[(L+1)^2, 512] features and the float16 cast on the host. One frame is in
flight (a closed loop); a frame's latency runs from the call to the
float16 features on the host.

``correct``: ``feat_gap``, over the kept frames the largest |program -
reference| of a frame's float32 features over that frame's largest
|reference| (``benchmark/reference/features.py`` on the same frames,
thetas and weights); ``rows_dropped`` and ``spans_clamped``, the program's
own counts (its binning record, ``stages.last_trace()``) of the instance
rows its caps dropped and of the Gaussians whose tile span they clamped,
over the kept frames run again after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, program, resnet
from benchmark.reference import features as reference
from benchmark.reference.model import Spec


class Session:
    kind = "render"

    def __init__(self, cell, seed: int, device):
        from pose_splatter_torch.preprocess.visual_features import make_frame_features

        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        t0 = time.perf_counter()
        self.spec = Spec(cell.config)
        self.block = dict(cell.config["visual_features"])
        self.inputs = program.Inputs(self.spec, seed, int(w["poses"]), device)
        t1 = time.perf_counter()
        self.model = program.build(cell.config, self.inputs)
        self.frame = make_frame_features(
            self.model, resnet_weights=resnet.make_weights(seed, device),
            rig=self.block)
        t2 = time.perf_counter()
        self.n_poses = int(w["poses"])
        self.share = float(w["sample_share"])
        self.rng = np.random.default_rng(seed + program.SCHEDULE_STREAM)
        self.i = 0
        self.kept = []  # (pose, theta, float32 features on the host)
        self.latencies = []
        self.attempted = self.failed = 0
        views = 2 * (int(self.block["L"]) + 1) ** 2
        self.flops_per_unit = (counts.model_flops(self.spec, train=False)
                               + views * resnet.flops(int(self.block["size"])))
        for _ in range(int(w["warmup_frames"])):
            self.unit()
        print(f"set-up: inputs {t1 - t0:.3f} s, model {t2 - t1:.3f} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", flush=True)
        self.kept = []
        self.latencies.clear()
        self.attempted = self.failed = 0

    def unit(self):
        """One frame: issue it, fetch its features, cast them to float16."""
        pose = self.i % self.n_poses
        theta = np.float32(2.0 * np.pi * self.rng.random())
        # Drawn from the seed; the first frame after set-up is always kept.
        keep = bool(self.rng.random() < self.share) or not self.kept
        inp = self.inputs
        t_issue = time.perf_counter()
        self.attempted += 1
        try:
            f32 = self.frame(inp.mask[pose], inp.img[pose], inp.p_3d[pose],
                             inp.angle[pose], theta).cpu().numpy()
            self.delivered = f32.astype(np.float16)
        except RuntimeError:
            self.failed += 1
            return
        self.latencies.append(time.perf_counter() - t_issue)
        if keep:
            self.kept.append((pose, float(theta), f32))
        self.i += 1

    def finish(self):
        """Nothing is left in flight: each frame ends on the host."""

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
        elapsed = time.perf_counter() - t0
        lat = np.asarray(self.latencies) * 1e3
        return {"render_frames_per_s": len(lat) / elapsed,
                "render_frame_ms_p95": float(np.percentile(lat, 95))}

    def counted(self) -> dict:
        """The program's binning counts over the kept frames, run again
        under ``stages.trace``."""
        from pose_splatter_torch.utils import stages

        inp = self.inputs
        with torch.no_grad(), stages.trace(self.device):
            for pose, theta, _ in self.kept:
                self.frame(inp.mask[pose], inp.img[pose], inp.p_3d[pose],
                           inp.angle[pose], np.float32(theta))
        units = stages.last_trace().units[-len(self.kept):]
        return dict(rows_dropped=sum(u["dropped_rows"] for u in units),
                    spans_clamped=sum(u.get("clamped_gaussians") or 0
                                      for u in units))

    def release(self):
        self.counts = self.counted() if self.kept else {}
        self.cameras = self.inputs.cameras()
        poses = sorted({k[0] for k in self.kept})
        self.ref_frames = {p: {k: v.clone() for k, v in self.inputs.frame(p).items()}
                           for p in poses}
        del self.model, self.frame
        self.inputs.mask = self.inputs.img = None
        program.free_cuda()

    def reference(self) -> list:
        """The reference's float32 features of each kept frame, in order."""
        rig = reference.Rig(self.block, self.device)
        return reference.features(
            self.inputs.weights(), resnet.make_weights(self.seed, self.device),
            self.spec, self.cameras, self.inputs.grid, rig,
            [self.ref_frames[p] for p, _, _ in self.kept],
            [t for _, t, _ in self.kept])

    def check(self) -> dict:
        limits = self.cell.workload["limits"]
        gap = float("inf")
        if self.kept:
            ref = [r.cpu().numpy() for r in self.reference()]
            gap = max(float(np.abs(f - r).max() / np.abs(r).max())
                      for (_, _, f), r in zip(self.kept, ref))
        values = dict(feat_gap=gap, **{k: float(self.counts.get(k, float("inf")))
                                       for k in ("rows_dropped", "spans_clamped")})
        return {k: dict(value=float(values[k]), limit=float(limits[k]))
                for k in limits}
