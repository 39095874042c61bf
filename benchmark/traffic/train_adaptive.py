"""Eager training with the adaptive camera, batch 1: what a user's training
run on a rig of crop videos does, each frame with its own intrinsics.

``train_eager``'s parameters, schedule, window and comparison (its
``Session``, by import), on the configuration's own scene (its ``scene``
block): the ring cameras of ``benchmark/scene.py`` with focal length
``focal`` at a render ``focal_height`` pixels high (scaled with the
render's height, so the bird keeps its share of the image), a textured
ellipsoid of semi-axes ``axes`` at the cube's centre,
and poses drawn from the seed with a yaw uniform over the full turn and a
shift ~N(0, ``shift_sigma``) an axis.

At set-up each frame's ``temp_K`` [C,3,3] and seed [3] come from the
program's host hook (``model.make_adaptive_fn()``) on the host copy of its
masks, as the trainer's loader threads make them beside the step, and are
staged on the device beside the frame; every step passes its frame's as
the batch's ``K_mask`` and ``seed_3d``. The hook's host ms a frame is
printed.

``correct``: ``train_eager``'s numbers (``compare.train_gaps``) against
``benchmark/reference/adaptive.py``, which computes its own ``temp_K`` and
seed from the masks, and ``first_loss_gap``, the relative gap of the first
checked step's loss. That loss is the one no update has touched, so it
holds the forward alone, tighter than the later losses can be held: they
carry the float32 round-off of the first gradients, which Adam turns into
steps (the final U-Net's BatchNorm weights and biases, sums over the whole
80^3 cube, read as far from a float64 reference in the float32 reference
as in the program). The cell's workload file names the numbers it compares.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import compare, program, scene
from benchmark.reference import adaptive as reference
from benchmark.reference.model import create_grid
from benchmark.traffic import train_eager


class Inputs(program.Inputs):
    """``program.Inputs`` on the scene block ``sc`` of the configuration."""

    def __init__(self, spec, seed: int, n_frames: int, device, sc: dict):
        self.spec, self.seed, self.device = spec, seed, device
        Ks, self.Es = scene.ring_cameras(spec.cameras, spec.W, spec.H, device)
        Ks[:, 0, 0] = Ks[:, 1, 1] = float(sc["focal"]) * spec.H / float(sc["focal_height"])
        self.Ks = Ks
        self.grid = torch.as_tensor(create_grid(spec), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + program.FRAMES_STREAM)
        self.p_3d = float(sc["shift_sigma"]) * torch.randn(
            (n_frames, 3), generator=gen, device=device)
        self.angle = 2 * math.pi * torch.rand((n_frames,), generator=gen,
                                              device=device)
        center = self.grid.reshape(-1, 3).double().mean(0)
        self.mask, self.img = scene.ellipsoid_frames(
            self.Ks, self.Es, spec.H, spec.W, center.tolist(), sc["axes"],
            self.p_3d, self.angle, spec.observed)


class Session(train_eager.Session):
    def __init__(self, cell, seed: int, device):
        if not cell.config.get("adaptive_camera"):
            raise ValueError(f"{cell.name}: the configuration has no adaptive camera")
        sc = cell.config["scene"]
        inputs = program.Inputs
        program.Inputs = lambda *args: Inputs(*args, sc)
        try:
            super().__init__(cell, seed, device)
        finally:
            program.Inputs = inputs

    def _stage_hook(self):
        """Each frame's temp_K and seed from the program's hook, on the
        device beside the frame."""
        hook = self.model.make_adaptive_fn()
        ks, seeds, ms = [], [], []
        for m in self.inputs.mask.cpu().numpy():
            t0 = time.perf_counter()
            temp_K, seed = hook(m)
            ms.append(1e3 * (time.perf_counter() - t0))
            ks.append(torch.as_tensor(temp_K, dtype=torch.float32))
            seeds.append(torch.as_tensor(seed, dtype=torch.float32))
        self.k_mask = torch.stack(ks).to(self.device)
        self.seed_3d = torch.stack(seeds).to(self.device)
        shift = (self.k_mask[:, :, :2, 2] - self.inputs.Ks[None, :, :2, 2]).abs().amax()
        print(f"set-up: hook {statistics.median(ms):.3f} ms a frame (median of "
              f"{len(ms)}, host); largest principal-point shift {float(shift):.4f} px",
              flush=True)

    def _checked(self, n: int):
        # A program that bins with other caps than the configuration's
        # drops rows the reference keeps: it cannot run this configuration.
        cap = self.cell.config["gaussian_config"].get("instance_cap")
        if getattr(self.model, "instance_cap", None) != cap:
            raise RuntimeError(f"{self.cell.name}: the program does not take "
                               f"gaussian_config's instance_cap {cap}")
        self._stage_hook()
        super()._checked(n)

    def _step(self):
        i, k = self._draw()
        inp = self.inputs
        batch = dict(mask=inp.mask[i:i + 1], img=inp.img[i:i + 1],
                     p_3d=inp.p_3d[i:i + 1], angle=inp.angle[i:i + 1],
                     view_idx=self.view_dev[k], obs_idx=self.obs_dev[k],
                     K_mask=self.k_mask[i:i + 1], seed_3d=self.seed_3d[i:i + 1])
        self.state, metrics = self.step_fn(self.state, batch)
        return (i, k), metrics

    def release(self):
        self.hooks = [(self.k_mask[i].cpu(), self.seed_3d[i].cpu())
                      for i, _ in self.checked]
        del self.k_mask, self.seed_3d
        super().release()

    def reference(self, lr=None) -> dict:
        weights = self.inputs.weights()
        ref = reference.train_steps(
            weights, self.spec, self.cameras, self.grid, self.ref_steps,
            self.spec.lr if lr is None else lr,
            self.cell.config["gaussian_config"].get("instance_cap"))
        # Both hooks on the same masks: the largest gap, for the log.
        gap = max(max(float((k - rk).abs().max()), float((s - rs.float()).abs().max()))
                  for (k, s), (rk, rs) in zip(self.hooks, ref["hooks"]))
        print(f"hook gap to the reference: {gap!r}", flush=True)
        return ref

    @staticmethod
    def gaps(prog: dict, ref: dict) -> dict:
        """``compare.train_gaps`` and ``first_loss_gap``."""
        out = compare.train_gaps(prog, ref)
        out["first_loss_gap"] = (abs(prog["losses"][0] - ref["losses"][0])
                                 / abs(ref["losses"][0]))
        return out

    def check(self) -> dict:
        gaps = self.gaps(self.prog, self.reference())
        return {k: dict(value=float(gaps[k]), limit=float(v))
                for k, v in self.cell.workload["limits"].items()}
