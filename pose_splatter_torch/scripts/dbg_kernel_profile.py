"""Microbenchmark of the instance-binned compositor's pieces on the card
(counterpart of ``scripts/dbg_pallas_profile.py``; "pallas" becomes
"kernel", as in ``ops/rasterize_kernels.py``).

    python -m pose_splatter_torch.scripts.dbg_kernel_profile [CHUNK]
        [TILE_H] [TILE_W] [full] [--device cuda|cpu] [--seed N]
        [--iters N] [--height H] [--width W] [--n N]

The bench scene (576x512, N = 16000, f = 900, seed 0), projected, depth
sorted and packed once, then binned at expand 16 (defaults: chunk 64,
tile (8, 128)). Prints the script's header line (tiles T, pixels a tile
P, ``mcap``, chunk) and instance line (total instances, overflow, largest
tile, chunk steps), then the lines bin, gather inst, gather inst bwd (the
gather's fwd+bwd), kernel fwd, kernel fwd empty (the counts zeroed: the
launch and scan cost of an empty frame), kernel fwd+bwd. With ``full``,
the script's ``full_path`` lines follow: ``rasterize`` in ``"kernel"``
mode at its default tile and chunk, forward, and fwd+bwd with respect to
means, opacities, colours and all five Gaussian inputs. Chunk and tile
beyond the kernels' limits raise (``rasterize_kernels.check_tile``).
Lines are ms a call (``probe_common``).
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


def run(chunk: int = DEFAULT_CHUNK, tile=DEFAULT_TILE, full: bool = False,
        device="cuda", seed: int = 0, iters: int = 20, H: int = H,
        W: int = W, N: int = N) -> Dict:
    tile = tuple(tile)
    K.check_tile(tile, chunk, max_chunk=512)  # the backward's limit
    probe = pc.Probe(device, iters, width=16, fmt="8.3f")
    scene = pc.bench_scene(probe.dev, H, W, N, seed)
    packed, mean2d, rad, ok = (x[None] for x in pc.project_packed(scene, H, W))

    origins, n_ty, n_tx = _tile_grid(H, W, tile, probe.dev)
    T = n_ty * n_tx
    mcap = K.instance_rows(N, T, EXPAND, chunk, cap=4 * N + T * chunk)
    print(f"T={T} tiles, P={tile[0] * tile[1]}, mcap={mcap}, chunk={chunk}")

    def build():
        return K._build_instances(mean2d, rad, ok, n_ty, n_tx, tile, EXPAND,
                                  chunk, mcap)

    dest, src, astarts, counts, overflow = build()[:5]
    astarts, counts = astarts[0].contiguous(), counts[0].contiguous()
    inst_line = dict(total_instances=int(counts.sum()),
                     overflow=int(overflow.sum()),
                     max_tile_count=int(counts.max()),
                     chunk_steps=int(((counts + chunk - 1) // chunk).sum()))
    print("total instances:", inst_line["total_instances"], "overflow:",
          inst_line["overflow"], "max tile count:",
          inst_line["max_tile_count"], "chunk steps:",
          inst_line["chunk_steps"])

    def gather_bwd():
        p = packed.detach().requires_grad_()
        return torch.autograd.grad(
            K.gather_instances(p, dest, src, mcap).sum(), p)

    probe.time("bin", build)
    probe.time("gather inst", lambda: K.gather_instances(packed, dest, src,
                                                         mcap))
    probe.time("gather inst bwd", gather_bwd)
    inst = K.gather_instances(packed, dest, src, mcap)[0].contiguous()
    zc = torch.zeros_like(counts)

    def compose_bwd():
        i = inst.detach().requires_grad_()
        rgb, alpha = K.composite_with_grad(i, astarts, counts, origins, tile,
                                           chunk, "conic")
        return torch.autograd.grad(pc.scalar_loss(rgb, alpha), i)

    probe.time("kernel fwd", lambda: K.composite_instances(
        inst, astarts, counts, origins, tile, chunk, "conic"))
    probe.time("kernel fwd empty", lambda: K.composite_instances(
        inst, astarts, zc, origins, tile, chunk, "conic"))
    probe.time("kernel fwd+bwd", compose_bwd)
    if full:
        full_path(probe, scene, H, W)
    return probe.result(T=T, P=tile[0] * tile[1], mcap=mcap, chunk=chunk,
                        **inst_line)


def full_path(probe: pc.Probe, scene, H: int, W: int) -> None:
    """``full_path()``'s lines (``dbg_pallas_profile.py:132-163``)."""
    bg = torch.ones(3, device=probe.dev)

    def fwd(*a):
        return rasterize(*a, scene[5], scene[6], W, H, backgrounds=bg,
                         mode="kernel")

    probe.time("full fwd", lambda: fwd(*scene[:5]))
    for argnums, name in [((0,), "means"), ((3,), "opac"), ((4,), "colors"),
                          ((0, 1, 2, 3, 4), "all")]:
        def grad(argnums=argnums):
            ps = [x.detach().requires_grad_(i in argnums)
                  for i, x in enumerate(scene[:5])]
            return torch.autograd.grad(pc.scalar_loss(*fwd(*ps)),
                                       [ps[i] for i in argnums])

        probe.time(f"fwd+bwd {name}", grad)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=20)
    ap.add_argument("chunk", type=int, nargs="?", default=DEFAULT_CHUNK)
    ap.add_argument("tile_h", type=int, nargs="?")
    ap.add_argument("tile_w", type=int, nargs="?")
    ap.add_argument("full", nargs="?", choices=["full"])
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--n", type=int, default=N)
    a = ap.parse_args(argv)
    tile = (a.tile_h, a.tile_w) if a.tile_w is not None else DEFAULT_TILE
    return run(a.chunk, tile, a.full == "full", a.device, a.seed, a.iters,
               a.height, a.width, a.n)


if __name__ == "__main__":
    main()
