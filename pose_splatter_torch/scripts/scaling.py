"""Weak-scaling report of the data-parallel train step (counterpart of
``scripts/scaling.py``).

    python -m pose_splatter_torch.scripts.scaling                # the card's ranks
    python -m pose_splatter_torch.scripts.scaling --virtual 4    # 4 gloo ranks on the CPU
    python -m pose_splatter_torch.scripts.scaling --out SCALING.json

Wires ``pose_splatter_torch.parallel.scaling_report`` to a PoseSplatter
data-parallel step: the batch of a rank is fixed, the global batch grows
with the rank count, and efficiency is global frames/s against perfect
linear scaling. The rows and keys are the JAX script's; "devices" are
ranks.

Without ``--virtual`` it runs on the card: in the group of a launcher
that set ``WORLD_SIZE`` / ``RANK``, else as one rank in a group of one
over NCCL (one row: the steps/s of one card), rendering through the
hand-written compositors (``"kernel"``). ``--virtual N`` starts N gloo
ranks on the CPU with the launcher (``parallel/launch.py``) and renders
``"tiled"`` with (16, 64) tiles, as the JAX script picks ``"tiled"`` off
the TPU; its rows share the host's cores, so they measure the collectives'
overhead (``spmd_efficiency``), not a speed.
"""

import argparse
import json
import re
import sys

import numpy as np

VIRTUAL_TIMEOUT_S = 1800.0  # the --virtual ranks' limit


def build_parser() -> argparse.ArgumentParser:
    from pose_splatter_torch.scripts.common import add_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--virtual", type=int, default=0,
                        help="start N gloo ranks on the CPU")
    parser.add_argument("--grid", type=int, default=16)
    parser.add_argument("--size", type=int, default=48, help="render W=H")
    parser.add_argument("--width", type=int, default=0,
                        help="render width (overrides --size)")
    parser.add_argument("--height", type=int, default=0,
                        help="render height (overrides --size)")
    parser.add_argument("--cameras", type=int, default=3)
    parser.add_argument("--crop", default=None,
                        help="volume_idx x0,x1,y0,y1,z0,z1 (north-star crop)")
    parser.add_argument("--min-n", type=int, default=16)
    parser.add_argument("--max-n", type=int, default=256)
    parser.add_argument("--mode", default="3d", choices=["2d", "3d"])
    parser.add_argument("--num-unets", type=int, default=2)
    parser.add_argument("--base-filters", type=int, default=4)
    parser.add_argument("--per-device-batch", type=int, default=1)
    parser.add_argument("--out", default=None)
    add_device(parser)
    return parser


def main(argv=None):
    import torch
    import torch.distributed as dist

    from pose_splatter_torch.models.pose_splatter import PoseSplatter
    from pose_splatter_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        replicate_state,
        scaling_report,
        shard_batch,
    )
    from pose_splatter_torch.parallel.launch import is_rank, launch
    from pose_splatter_torch.parallel.multihost import process_group
    from pose_splatter_torch.train.loop import create_train_state
    from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical

    args = build_parser().parse_args(argv)
    if args.virtual and not is_rank():
        argv = sys.argv[1:] if argv is None else list(argv)
        results = launch(args.virtual, ["-m", "pose_splatter_torch.scripts."
                                        "scaling", *argv],
                         timeout=VIRTUAL_TIMEOUT_S)
        out = results[0].output
        sys.stdout.write(out)
        return json.loads(re.search(r"^\{$.*^\}$", out, re.M | re.S).group())
    device = "cpu" if args.virtual else args.device

    C, g = args.cameras, args.grid
    W = args.width or args.size
    H = args.height or args.size
    if args.crop:
        v = [int(x) for x in args.crop.split(",")]
        volume_idx = [[v[0], v[1]], [v[2], v[3]], [v[4], v[5]]]
    else:
        volume_idx = [[0, g]] * 3
    f = 1.4 * max(W, H)
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C,
                  np.float32)
    Es = np.stack([
        camera_extrinsic_spherical(1.2, np.pi / 3, 2 * np.pi * i / C)
        for i in range(C)
    ]).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    mask = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2)
            < (H / 4) ** 2).astype(np.float32)
    img = np.stack([mask * 0.7, mask * 0.3, mask * 0.5], -1)

    with process_group(device) as dev:
        on_card = dev.type == "cuda"

        def make_step_and_inputs(ranks):
            n = len(ranks)
            B = n * args.per_device_batch
            mesh = make_mesh((n,), ("data",), devices=ranks)
            if mesh.coords is None:
                return None, None, None
            model = PoseSplatter(
                Ks, Es, W, H, ell=0.5, grid_size=g, volume_idx=volume_idx,
                min_n=args.min_n, max_n=args.max_n,
                num_unets=args.num_unets, base_filters=args.base_filters,
                gaussian_mode=args.mode,
                render_mode="kernel" if on_card else "tiled",
                tile_shape=None if on_card else (16, 64), device=dev)
            state = replicate_state(create_train_state(model, 1e-3), mesh)
            step_fn = make_sharded_train_step(
                model, state.optimizer, img_lambda=0.5, ssim_lambda=0.0,
                mesh=mesh)
            batch = dict(
                mask=np.broadcast_to(np.stack([mask] * C)[None], (B, C, H, W)),
                img=np.broadcast_to(np.stack([img] * C)[None],
                                    (B, C, H, W, 3)),
                p_3d=np.zeros((B, 3), np.float32),
                angle=np.linspace(0, 0.4, B).astype(np.float32),
                view_idx=np.zeros((B,), np.int32),
                obs_idx=np.zeros((B,), np.int32),
            )
            local = {k: torch.as_tensor(np.array(v), device=dev)
                     for k, v in shard_batch(batch, mesh).items()}
            return step_fn, state, local

        report = scaling_report(make_step_and_inputs,
                                spmd_baseline=bool(args.virtual))
        report["backend"] = dist.get_backend()
        report["devices_total"] = dist.get_world_size()
        rank = dist.get_rank()
    report["per_device_batch"] = args.per_device_batch
    report["config"] = (f"{W}x{H} grid{g} C{C} mode={args.mode} "
                        f"unets{args.num_unets} bf{args.base_filters}"
                        + (f" crop({args.crop})" if args.crop else ""))
    if on_card:
        from pose_splatter_torch.scripts.common import card_line

        report["card"] = card_line()
    mpix = W * H / 1e6
    for row in report.get("rows", []):
        row["mpix_per_s_per_device"] = round(
            row["steps_per_s"] * args.per_device_batch * mpix, 3)
    if rank == 0:
        print(json.dumps(report, indent=2))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
