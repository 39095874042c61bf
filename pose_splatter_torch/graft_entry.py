"""Entry points (counterpart of ``__graft_entry__.py``): the flagship 3D
``PoseSplatter`` forward, carve → U-Nets → Gaussian head → tiled
rasterize, on a small model, and the multi-rank dry run.

    fn, example_args = entry()          # on the card
    rgb, alpha = fn(*example_args)

    python -m pose_splatter_torch.graft_entry --dryrun 1    # the card
    python -m pose_splatter_torch.graft_entry --dryrun 4 --device cpu

``--dryrun N`` runs :func:`dryrun_multichip` in each of N ranks: on the
CPU the launcher starts N gloo ranks; on the card N ranks need N cards
(NCCL takes one rank a card), and one rank forms a group of one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Union

import numpy as np
import torch

from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical

DRYRUN_TIMEOUT_S = 600.0  # the launched ranks' limit (about 10 s on a CPU)


def _build_model(grid_size: int = 32, H: int = 64, W: int = 64, C: int = 3,
                 render_mode: str = "tiled",
                 device: Union[str, torch.device] = "cuda"):
    """The JAX entry's model (``__graft_entry__.py:6-28``): C cameras on a
    ring at radius 1.5, f = 80, ell 0.6, 2 U-Nets of width 8, 3D Gaussians
    (64 to 1024), ``tile_shape`` (32, 64); with a disc mask and a tinted
    image per camera. Returns (model, masks [C,H,W], imgs [C,H,W,3])."""
    f = 80.0
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C, np.float32)
    Es = np.stack([
        camera_extrinsic_spherical(1.5, np.pi / 3, 2 * np.pi * i / C)
        for i in range(C)
    ]).astype(np.float32)
    model = PoseSplatter(
        Ks, Es, W, H,
        ell=0.6, grid_size=grid_size, min_n=64, max_n=1024,
        volume_idx=[[0, grid_size]] * 3, num_unets=2, base_filters=8,
        gaussian_mode="3d", render_mode=render_mode, tile_shape=(32, 64),
        device=device,
    )
    yy, xx = np.mgrid[0:H, 0:W]
    mask = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 4) ** 2).astype(np.float32)
    masks = np.stack([mask] * C)
    imgs = np.stack([np.stack([mask * 0.8, mask * 0.2, mask * 0.5], -1)] * C)
    return model, masks, imgs


def entry(device: Union[str, torch.device] = "cuda"):
    """Returns ``(fn, example_args)``. ``fn(variables, mask, img, p_3d,
    angle, view_idx)`` is the model's eval forward and returns (rgb
    [1,H,W,3], alpha [1,H,W]); ``variables`` is the net's parameters and
    buffers by name (a state dict of ``model.net``), applied with
    ``torch.func.functional_call``, so that the weights are an argument as
    in JAX."""
    model, masks, imgs = _build_model(device=device)
    dev = model.device
    variables = {k: v.detach().clone() for k, v in
                 list(model.net.named_parameters())
                 + list(model.net.named_buffers())}

    def fn(variables, mask, img, p_3d, angle, view_idx):
        bound = {f"net.{k}": v for k, v in variables.items()}
        return torch.func.functional_call(
            model, bound, (mask, img, p_3d, angle, view_idx))

    example_args = (
        variables,
        torch.as_tensor(masks, device=dev),
        torch.as_tensor(imgs, device=dev),
        torch.zeros(3, device=dev),
        torch.tensor(0.3, device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device] = "cuda") -> None:
    """Run in each rank of an ``n_devices``-rank group (or alone for 1):
    ONE data-parallel train step (frame batch split over the ``data``
    axis, gradients averaged) through the ``"tiled"`` compositor with 4
    (16, 32) tiles a 32x64 frame, its loss within 1e-4 relative of the
    unsharded ``make_train_step`` on the whole batch; then ONE (data, tile)
    step, data = 2 if ``n_devices`` is even else 1, through the
    ``"kernel"`` compositor (the JAX package's ``"pallas"``: the CUDA
    kernels on the card, their plain versions on the CPU) on (8, 32)
    tiles, within 1e-3 of the unsharded step. Raises on a mismatch; rank
    0 prints the JAX function's two ``OK`` lines."""
    from pose_splatter_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        replicate_state,
        shard_batch,
    )
    from pose_splatter_torch.parallel.mesh import world
    from pose_splatter_torch.parallel.tile_sharding import (
        make_tile_sharded_train_step,
    )
    from pose_splatter_torch.train.loop import create_train_state, make_train_step

    rank, size = world()
    if size != n_devices:
        raise ValueError(f"need {n_devices} ranks, the group has {size}")
    mesh = make_mesh()

    def build():
        # The JAX dry run's model: tiled binning with 4 (16, 32) tiles per
        # 32x64 frame, 16 to 64 Gaussians (every twin from seed 0).
        m, masks, imgs = _build_model(grid_size=16, H=32, W=64, C=2,
                                      render_mode="tiled", device=device)
        m.min_n, m.max_n = 16, 64
        m.tile_shape = (16, 32)
        return m, masks, imgs

    model, masks, imgs = build()
    rng = np.random.default_rng(0)
    B = n_devices
    # Distinct per-frame pose jitter so every rank's shard differs.
    batch = dict(
        mask=np.stack([masks[:2]] * B),
        img=np.stack([imgs[:2]] * B),
        p_3d=(0.02 * rng.normal(size=(B, 3))).astype(np.float32),
        angle=(0.1 * rng.normal(size=(B,))).astype(np.float32),
        view_idx=np.zeros((B,), np.int32),
        obs_idx=np.zeros((B,), np.int32),
    )
    lr = 1e-3
    state = replicate_state(create_train_state(model, lr), mesh)
    init = {k: v.detach().clone() for k, v in model.net.state_dict().items()}

    def twin():
        m = build()[0]
        m.net.load_state_dict(init)
        return m, create_train_state(m, lr)

    step = make_sharded_train_step(model, state.optimizer, 0.5, 0.1, mesh)
    _, metrics = step(state, shard_batch(batch, mesh))
    sharded_loss = float(metrics["total"])

    # Unsharded reference: the same batch through the plain step.
    ref, ref_state = twin()
    _, ref_metrics = make_train_step(ref, ref_state.optimizer, 0.5, 0.1,
                                     batch_size=B)(ref_state, batch)
    ref_loss = float(ref_metrics["total"])
    if not abs(sharded_loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss)):
        raise AssertionError(f"sharded loss {sharded_loss} != unsharded "
                             f"{ref_loss}")
    if rank == 0:
        print(f"dryrun_multichip({n_devices}) OK: loss={sharded_loss:.6f} "
              f"(unsharded {ref_loss:.6f}, tiled compositor, 4 tiles/frame)",
              flush=True)

    # The kernel compositor inside the (data, tile) step, from the same
    # initial weights.
    n_data = 2 if n_devices % 2 == 0 else 1
    n_tile = n_devices // n_data
    mesh2 = make_mesh((n_data, n_tile), ("data", "tile"))
    tmodel, tstate = twin()
    tile_step = make_tile_sharded_train_step(
        tmodel, tstate.optimizer, 0.5, 0.1, mesh2, tile_shape=(8, 32),
        tile_capacity=128, compositor="kernel")
    batch2 = {k: v[:n_data] for k, v in batch.items()}
    _, tile_loss = tile_step(tstate, shard_batch(batch2, mesh2, "data"))
    ref2, ref2_state = twin()
    _, ref2_metrics = make_train_step(ref2, ref2_state.optimizer, 0.5, 0.1,
                                      batch_size=n_data)(ref2_state, batch2)
    ref2_loss = float(ref2_metrics["total"])
    tile_loss = float(tile_loss)
    if not abs(tile_loss - ref2_loss) <= 1e-3 * max(1.0, abs(ref2_loss)):
        raise AssertionError(f"kernel (data,tile) loss {tile_loss} != "
                             f"unsharded {ref2_loss}")
    if rank == 0:
        print(f"dryrun_multichip({n_devices}) OK: kernel compositor in the "
              f"(data={n_data}, tile={n_tile}) step, "
              f"loss={tile_loss:.6f} (unsharded {ref2_loss:.6f})", flush=True)


def main(argv=None) -> int:
    from pose_splatter_torch.parallel.launch import is_rank, launch
    from pose_splatter_torch.parallel.multihost import process_group
    from pose_splatter_torch.scripts.common import add_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dryrun", type=int, required=True, metavar="N",
                        help="run dryrun_multichip(N) in N ranks")
    add_device(parser)
    args = parser.parse_args(argv)
    if args.dryrun > 1 and not is_rank():
        argv = sys.argv[1:] if argv is None else list(argv)
        results = launch(args.dryrun, ["-m", "pose_splatter_torch.graft_entry",
                                       *argv], timeout=DRYRUN_TIMEOUT_S)
        sys.stdout.write(results[0].output)
        return 0
    with process_group(args.device) as dev:
        dryrun_multichip(args.dryrun, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
