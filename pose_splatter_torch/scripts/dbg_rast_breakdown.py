"""Break down the rasterizer's fwd+bwd at the bench shape (counterpart of
``scripts/dbg_rast_breakdown.py``).

    python -m pose_splatter_torch.scripts.dbg_rast_breakdown
        [--device cuda|cpu] [--seed N] [--iters N] [--height H]
        [--width W] [--n N]

The bench scene (576x512, N = 16000, f = 900, seed 0) in ``"kernel"``
mode at tile (8, 128), chunk 64, with the script's lines in its order:
full fwd and full fwd+bwd (``rasterize``), proj+sort+pack, the grid line
(tiles, ``mcap``), bin only (``_build_instances`` at expand 16), the counts
line (total instances, largest tile, overflow), gather fwd and gather
fwd+bwd (``gather_instances`` and its backward), kernel fwd and kernel
fwd+bwd (``composite_instances``, and ``composite_with_grad`` with the
backward compositor). Lines are ms a call (``probe_common``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.ops.rasterize import (
    DEFAULT_CHUNK,
    DEFAULT_TILE,
    _tile_grid,
    rasterize,
)
from pose_splatter_torch.scripts import probe_common as pc

H, W, N = 512, 576, 16000
EXPAND = 16


def run(device="cuda", seed: int = 0, iters: int = 20, H: int = H,
        W: int = W, N: int = N) -> Dict:
    tile, chunk = DEFAULT_TILE, DEFAULT_CHUNK
    probe = pc.Probe(device, iters, width=20, fmt=".2f")
    scene = pc.bench_scene(probe.dev, H, W, N, seed)
    bg = torch.ones(3, device=probe.dev)

    def fwd(*a):
        return rasterize(*a, scene[5], scene[6], W, H, backgrounds=bg,
                         mode="kernel")

    def full_grad():
        ps = [x.detach().requires_grad_() for x in scene[:5]]
        return torch.autograd.grad(pc.scalar_loss(*fwd(*ps)), ps)

    probe.time("full fwd", lambda: fwd(*scene[:5]))
    probe.time("full fwd+bwd", full_grad)
    probe.time("proj+sort+pack", lambda: pc.project_packed(scene, H, W))
    packed, mean2d, rad, ok = (x[None] for x in pc.project_packed(scene, H, W))

    origins, n_ty, n_tx = _tile_grid(H, W, tile, probe.dev)
    T = n_ty * n_tx
    mcap = K.instance_rows(N, T, EXPAND, chunk, cap=4 * N + T * chunk)
    print(f"tiles={T} mcap={mcap}")

    def bin_only():
        return K._build_instances(mean2d, rad, ok, n_ty, n_tx, tile, EXPAND,
                                  chunk, mcap)

    probe.time("bin only", bin_only)
    dest, src, astarts, counts, overflow = bin_only()[:5]
    total, biggest, over = (int(counts.sum()), int(counts.max()),
                            int(overflow.sum()))
    print("counts: total inst=%d max tile=%d overflow=%d"
          % (total, biggest, over))

    def gather_vjp():
        p = packed.detach().requires_grad_()
        return torch.autograd.grad(
            K.gather_instances(p, dest, src, mcap).sum(), p)

    probe.time("gather fwd", lambda: K.gather_instances(packed, dest, src,
                                                        mcap))
    probe.time("gather fwd+bwd", gather_vjp)
    inst = K.gather_instances(packed, dest, src, mcap)[0].contiguous()
    astarts, counts = astarts[0].contiguous(), counts[0].contiguous()

    def kern_vjp():
        i = inst.detach().requires_grad_()
        rgb, alpha = K.composite_with_grad(i, astarts, counts, origins, tile,
                                           chunk, "conic")
        return torch.autograd.grad(pc.scalar_loss(rgb, alpha), i)

    probe.time("kernel fwd", lambda: K.composite_instances(
        inst, astarts, counts, origins, tile, chunk, "conic"))
    probe.time("kernel fwd+bwd", kern_vjp)
    return probe.result(tiles=T, mcap=mcap, total_inst=total, max_tile=biggest,
                        overflow=over)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=20)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--n", type=int, default=N)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters, a.height, a.width, a.n)


if __name__ == "__main__":
    main()
