"""Stage breakdown of the full PoseSplatter step at the north-star shape
(counterpart of ``scripts/dbg_model_breakdown.py``).

    python -m pose_splatter_torch.scripts.dbg_model_breakdown
        [--device cuda|cpu] [--seed N] [--iters N] [--width W]
        [--height H] [--grid G] [--crop i1,i2,i3,i4,i5,i6] [--cameras C]
        [--min-n N] [--max-n N]

The script's model and frame: 576x512, grid 128 cropped to
[[0,128],[0,128],[32,96]], 6 cameras on a ring (f = 1.7·W), holdout view
[5], 2D Gaussians centred by ``init_means2d_center``, min_n 512, max_n
8192, ``"kernel"`` render mode, weights from ``--seed``; a disc of radius
H/5 as every view's mask, its image the disc in (0.7, 0.3, 0.5); p_3d 0,
angle 0.2. Lines, in the script's order, ms a call (``probe_common``; 5
calls after one):

- carve; carve+unets; carve+unets+heads (no graph, BN on its running
  statistics); full fwd (eval): ``PoseSplatter.forward``;
- train step (fwd+bwd+adam): ``train/loop.py::make_train_step`` (lr 1e-3,
  img 0.5, ssim 0.1), each step from where the last left the weights (the
  JAX step restarts from one state); the weights are restored after;
- the backward, split (BN on its running statistics, the gradients of
  every parameter): grad: carve+unets (of mean(flat²) after the U-Nets),
  grad: thru render (of mean(rgb²) + mean(α²) of view 0 after the head
  and the render), grad: full loss (ssim) (``train/losses.py::total_loss``
  against view 0, img 0.5, ssim 0.1).
"""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.models.pose_splatter import (
    PoseSplatter,
    init_means2d_center,
)
from pose_splatter_torch.scripts import probe_common as pc
from pose_splatter_torch.train.loop import create_train_state, make_train_step
from pose_splatter_torch.train.losses import total_loss
from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical

C, H, W, GRID = 6, 512, 576, 128
CROP = (0, 128, 0, 128, 32, 96)
MIN_N, MAX_N = 512, 8192


def size_args(ap: argparse.ArgumentParser) -> None:
    """The flags that size the model and frame (defaults: the script's)."""
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--crop", default=",".join(map(str, CROP)))
    ap.add_argument("--cameras", type=int, default=C)
    ap.add_argument("--min-n", type=int, default=MIN_N)
    ap.add_argument("--max-n", type=int, default=MAX_N)


def sizes(a: argparse.Namespace) -> Dict:
    crop = [int(v) for v in a.crop.split(",")]
    return dict(W=a.width, H=a.height, grid=a.grid, C=a.cameras,
                crop=[crop[0:2], crop[2:4], crop[4:6]], min_n=a.min_n,
                max_n=a.max_n)


def model_and_frame(dev, seed: int = 0, W: int = W, H: int = H,
                    grid: int = GRID, C: int = C, crop=None,
                    min_n: int = MIN_N, max_n: int = MAX_N,
                    ablation: bool = False, num_unets: int = 3):
    """The scripts' model on ``dev`` (2D means centred unless
    ``ablation``), and the frame: a batch of one (mask [1,C',H,W], img
    [1,C',H,W,3], p_3d, angle, view_idx, obs_idx)."""
    crop = crop or [list(CROP[0:2]), list(CROP[2:4]), list(CROP[4:6])]
    f = 1.7 * W
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C, np.float32)
    Es = np.stack([camera_extrinsic_spherical(1.0, np.pi / 2.2,
                                              2 * np.pi * i / C)
                   for i in range(C)]).astype(np.float32)
    model = PoseSplatter(Ks, Es, W, H, ell=0.35, grid_size=grid,
                         volume_idx=crop, holdout_views=[C - 1],
                         gaussian_mode="2d", render_mode="kernel",
                         min_n=min_n, max_n=max_n, ablation=ablation,
                         num_unets=num_unets, device=dev, seed=seed)
    if not ablation:
        init_means2d_center(model.net, W, H)
    yy, xx = np.mgrid[0:H, 0:W]
    m = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 5) ** 2).astype(
        np.float32)
    n_obs = len(model.observed_views)
    mask = np.stack([m] * n_obs)
    img = np.stack([np.stack([m * .7, m * .3, m * .5], -1)] * n_obs)
    batch = dict(mask=mask[None], img=img[None],
                 p_3d=np.zeros((1, 3), np.float32),
                 angle=np.full((1,), 0.2, np.float32),
                 view_idx=np.zeros((1,), np.int64),
                 obs_idx=np.zeros((1,), np.int64))
    return model, {k: torch.from_numpy(np.asarray(v)).to(dev)
                   for k, v in batch.items()}


def run(device="cuda", seed: int = 0, iters: int = 5, **size) -> Dict:
    probe = pc.Probe(device, iters, width=28, fmt="9.2f")
    model, batch = model_and_frame(probe.dev, seed, **size)
    mask, img = batch["mask"][0], batch["img"][0]
    p3d, ang = batch["p_3d"][0], batch["angle"][0]
    net = model.net
    params = list(net.parameters())

    def volume():
        return model.carve(mask, img, p3d, ang).permute(1, 2, 3, 0)[None]

    with torch.no_grad():
        probe.time("carve", lambda: model.carve(mask, img, p3d, ang))
        probe.time("carve+unets", lambda: net.process_volume(volume()))
        probe.time("carve+unets+heads", lambda: model.gaussians_from_volume(
            net.process_volume(volume())))
    probe.time("full fwd (eval)", lambda: model(mask, img, p3d, ang, 0))

    saved = copy.deepcopy(net.state_dict())
    state = create_train_state(model, 1e-3)
    step = make_train_step(model, state.optimizer, img_lambda=0.5,
                           ssim_lambda=0.1)
    probe.time("train step (fwd+bwd+adam)", lambda: step(state, batch))
    net.load_state_dict(saved)

    def t_grad(name, loss_fn):
        probe.time(name, lambda: torch.autograd.grad(loss_fn(), params,
                                                     allow_unused=True))

    def rendered():
        g = model.gaussians_from_volume(net.process_volume(volume()))
        rgb, alpha, _ = model.render(g, [0])
        return rgb, alpha

    def full_loss():
        rgb, alpha = rendered()
        return total_loss(rgb[0], alpha[0], img[0], mask[0], 0.5, 0.1)[0]

    t_grad("grad: carve+unets",
           lambda: (net.process_volume(volume()) ** 2).mean())
    t_grad("grad: thru render",
           lambda: sum((x ** 2).mean() for x in rendered()))
    t_grad("grad: full loss (ssim)", full_loss)
    model.check_selection()
    return probe.result(image=f"{model.W}x{model.H}",
                        grid=list(model.input_size), max_n=model.max_n)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=5)
    size_args(ap)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters, **sizes(a))


if __name__ == "__main__":
    main()
