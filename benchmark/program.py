"""The system under test and the inputs both sides share.

``build`` makes the program's model (``pose_splatter_torch``'s
``build_model``, the entry point users call) for a configuration on the
benchmark's ring cameras and loads the benchmark's weights into it.
``Inputs`` are what the benchmark makes from the seed and hands to both
the program and the reference: the rig, the frames, the weights.
"""

from __future__ import annotations

import torch

from benchmark import scene, weights
from benchmark.reference.model import Cameras, Spec, create_grid

# The ellipsoid's semi-axes: about 1e4 voxels carved at grid 128, as a
# mouse occupies (0.7 times the program's own smoke scene, whose 4e4 carved
# voxels exceed max_n and leave every opacity near zero).
AXES = (0.0385, 0.0224, 0.0196)
# Offsets of the independent random streams drawn from one seed.
FRAMES_STREAM = 1_000_003
SCHEDULE_STREAM = 2_000_003


class Inputs:
    """The rig and ``n_frames`` poses' frames (observed views only), on
    ``device``, from ``seed``."""

    def __init__(self, spec: Spec, seed: int, n_frames: int, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.Ks, self.Es = scene.ring_cameras(spec.cameras, spec.W, spec.H, device)
        self.grid = torch.as_tensor(create_grid(spec), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + FRAMES_STREAM)
        self.p_3d, self.angle = scene.draw_poses(n_frames, gen, device)
        center = self.grid.reshape(-1, 3).double().mean(0)
        self.mask, self.img = scene.ellipsoid_frames(
            self.Ks, self.Es, spec.H, spec.W, center.tolist(),
            AXES, self.p_3d, self.angle, spec.observed)

    def cameras(self) -> Cameras:
        return Cameras(self.Ks, self.Es, self.spec)

    def frame(self, i: int) -> dict:
        return dict(mask=self.mask[i], img=self.img[i], p_3d=self.p_3d[i],
                    angle=self.angle[i])

    def weights(self):
        return weights.make_weights(self.spec, self.seed, self.device)


def build(config: dict, inputs: Inputs):
    """The program's model for ``config`` on the inputs' rig and device,
    with the benchmark's weights loaded."""
    from pose_splatter_torch.config import Config
    from pose_splatter_torch.train.trainer import build_model

    cams = (inputs.Ks.cpu().numpy(), inputs.Es.cpu().numpy())
    with torch.device(inputs.device):
        model = build_model(Config(config), device=inputs.device, cameras=cams)
    model.net.load_state_dict(inputs.weights(), strict=True)
    return model


def free_cuda():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
