"""Grid-256 / 1152x1024 (data, tile)-sharded train step: the existence
proof of the high-res layout (counterpart of
``scripts/dbg_highres_sharded.py``).

    python -m pose_splatter_torch.scripts.dbg_highres_sharded --devices 1
    python -m pose_splatter_torch.scripts.dbg_highres_sharded --devices 2 \\
        --device cpu --width 96 --height 64 --grid 32 --crop 0,32,0,32,8,24

Runs ``--steps`` steps of ``make_tile_sharded_train_step`` (strip-halo
SSIM, per-strip losses, averaged gradients) on a (data = 1, tile =
``--devices``) mesh at the JAX script's shape by default: 6 cameras at
1152x1024, grid 256 with the crop (192, 160, 128), 2D Gaussians not
anchored (1024 to 16000), (32, 128) tiles of capacity 4096 through the
``"tiled"`` compositor (the JAX ``"xla"``; the kernels take at most 1024
pixels a tile). The size flags exist so that a small copy runs on the CPU;
the JAX script has none.

On the card the ranks are cards: ``--devices 1`` runs in a group of one
over NCCL, and N > 1 starts N ranks with the launcher, one a card. With
``--device cpu`` the launcher starts ``--devices`` gloo ranks. Prints the
JAX script's report (seconds unrounded) with the peak device memory on the
card.
"""

import argparse
import json
import sys
import time

import numpy as np

# The launched ranks' limit: the full shape on the CPU takes hours.
LAUNCH_TIMEOUT_S = 6 * 3600.0
C = 6  # cameras

def build_parser() -> argparse.ArgumentParser:
    from pose_splatter_torch.scripts.common import add_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=8,
                        help="ranks on the tile axis")
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--out", default=None)
    parser.add_argument("--width", type=int, default=1152)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--grid", type=int, default=256)
    parser.add_argument("--crop", default="0,192,32,192,50,178",
                        help="volume_idx x0,x1,y0,y1,z0,z1")
    parser.add_argument("--min-n", type=int, default=1024)
    parser.add_argument("--max-n", type=int, default=16000)
    parser.add_argument("--carve-cap", type=int, default=262144,
                        help="the carve's visibility cap (0: exact)")
    parser.add_argument("--tile", default="32,128", help="tile shape th,tw")
    parser.add_argument("--capacity", type=int, default=4096,
                        help="Gaussians a tile keeps")
    add_device(parser)
    return parser


def main(argv=None):
    import torch
    import torch.distributed as dist

    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.models.unet3d import init_unet_primary_skip
    from pose_splatter_torch.parallel import make_mesh, shard_batch
    from pose_splatter_torch.parallel.launch import is_rank, launch
    from pose_splatter_torch.parallel.multihost import process_group
    from pose_splatter_torch.parallel.tile_sharding import (
        make_tile_sharded_train_step,
    )
    from pose_splatter_torch.scripts.synthetic_benchmark import build_model
    from pose_splatter_torch.train.loop import create_train_state

    args = build_parser().parse_args(argv)
    if args.devices > 1 and not is_rank():
        argv = sys.argv[1:] if argv is None else list(argv)
        results = launch(args.devices, ["-m", "pose_splatter_torch.scripts."
                                        "dbg_highres_sharded", *argv],
                         timeout=LAUNCH_TIMEOUT_S)
        sys.stdout.write(results[0].output)
        return 0

    W, H, g = args.width, args.height, args.grid
    crop = [int(x) for x in args.crop.split(",")]
    tile = tuple(int(x) for x in args.tile.split(","))
    with process_group(args.device) as dev:
        if dist.get_world_size() != args.devices:
            raise ValueError(f"--devices {args.devices} but the group has "
                             f"{dist.get_world_size()} ranks")
        model = build_model(C, H, W, g, "2d", crop=args.crop, anchored=False,
                            min_n=args.min_n, max_n=args.max_n,
                            carve_cap=args.carve_cap or None, device=dev)
        obs = model.observed_views
        state = create_train_state(model, 1e-4)
        init_unet_primary_skip(model.net)
        init_means2d_center(model.net, W, H)

        yy, xx = np.mgrid[0:H, 0:W]
        m = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2)
             < (H / 5) ** 2).astype(np.float32)
        mask = np.stack([m] * len(obs))
        img = np.stack([np.stack([m * .7, m * .3, m * .5], -1)] * len(obs))

        mesh = make_mesh((1, args.devices), ("data", "tile"))
        step = make_tile_sharded_train_step(
            model, state.optimizer, img_lambda=0.5, ssim_lambda=0.1,
            mesh=mesh, tile_shape=tile, tile_capacity=args.capacity,
            compositor="tiled")
        batch = shard_batch(dict(
            mask=torch.as_tensor(mask, device=dev)[None],
            img=torch.as_tensor(img, device=dev)[None],
            p_3d=torch.zeros((1, 3), device=dev),
            angle=torch.zeros((1,), device=dev),
            view_idx=torch.zeros((1,), dtype=torch.int32, device=dev),
            obs_idx=torch.zeros((1,), dtype=torch.int32, device=dev),
        ), mesh, "data")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        if dev.type == "cuda":
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        st, loss = step(state, batch)
        sync()
        first = time.perf_counter() - t0
        loss0 = float(loss)
        times = []
        for _ in range(max(0, args.steps - 1)):
            t0 = time.perf_counter()
            st, loss = step(st, batch)
            sync()
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else None)
        backend = dist.get_backend()
        rank = dist.get_rank()

    n_vox = (crop[1] - crop[0]) * (crop[3] - crop[2]) * (crop[5] - crop[4])
    dims = (crop[1] - crop[0], crop[3] - crop[2], crop[5] - crop[4])
    report = dict(
        config=f"{W}x{H} grid{g} crop{dims} 2d C{C} "
               f"(data=1, tile={args.devices}) strip-halo SSIM",
        voxels=n_vox,
        first_step_s=first,
        steady_step_s=float(np.mean(times)) if times else None,
        loss=loss0,
        loss_finite=bool(np.isfinite(loss0)),
        backend=backend,
        peak_bytes_above_start=peak,
        note=("Existence proof of the (data, tile) layout at the high-res "
              "shape: one rank a tile strip, each holding the whole model "
              "and its own image band."),
    )
    if dev.type == "cuda":
        from pose_splatter_torch.scripts.common import card_line

        report["card"] = card_line()
    if rank == 0:
        print(json.dumps(report, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
