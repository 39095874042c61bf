"""Stage-by-stage timing of the rasterizer on the bench workload
(counterpart of ``scripts/bench_breakdown.py``).

    python -m pose_splatter_torch.scripts.bench_breakdown [CHUNK] [TILE_H]
        [TILE_W] [EXPAND] [--device cuda|cpu] [--seed N] [--iters N]
        [--height H] [--width W] [--n N]

The bench scene (576x512, N = 16000 Gaussians in a cluster, f = 900, seed
0; ``bench.py::run_3d``'s draws) in ``"kernel"`` mode, with the script's
six lines in its order: project+sort, +bin+compose fwd (projection, sort,
binning and the forward compositor), compose fwd and compose fwd+bwd (the
binning and the compositors on the sorted, packed Gaussians, the backward
of Σrgb² + Σα² with respect to the packed rows), full fwd and full
fwd+bwd (``rasterize`` and its gradients through means, quats, scales,
opacities and colours). Defaults: chunk 64, tile (8, 128), expand 16.

The hand-written compositors take tiles of at most 1024 pixels and chunks
of at most 768 rows forward, 512 backward
(``rasterize_kernels.check_tile``): other arguments raise, on every
device; nothing falls back to the plain version. Lines are ms a call
(``probe_common``: CUDA events on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from pose_splatter_torch.ops.rasterize import (
    DEFAULT_CHUNK,
    DEFAULT_TILE,
    _composite_instances,
    rasterize,
)
from pose_splatter_torch.ops.rasterize_kernels import check_tile
from pose_splatter_torch.scripts import probe_common as pc
from pose_splatter_torch.utils import stages

H, W, N = 512, 576, 16000
EXPAND = 16


def run(chunk: int = DEFAULT_CHUNK, tile=DEFAULT_TILE, expand: int = EXPAND,
        device="cuda", seed: int = 0, iters: int = 20, H: int = H,
        W: int = W, N: int = N, record: bool = False) -> Dict:
    """The six lines. With ``record``, one more compose fwd+bwd runs inside
    ``stages.record()`` and the result holds that recording under
    ``"recording"`` (the binned arrays, ``tbounds`` and pixel gradients the
    compositors got), for holding the kernels against their plain
    versions."""
    tile = tuple(tile)
    check_tile(tile, chunk, max_chunk=512)  # the backward's limit
    probe = pc.Probe(device, iters, width=16)
    scene = pc.bench_scene(probe.dev, H, W, N, seed)
    bg = torch.ones(3, device=probe.dev)

    def compose(packed, mean2d, rad, ok):
        rgb, alpha, _ = _composite_instances(
            packed[None], mean2d[None], rad[None], ok[None], "conic", H, W,
            tile, chunk, expand)
        return rgb, alpha

    def stage_all():
        return compose(*pc.project_packed(scene, H, W))

    inputs = pc.project_packed(scene, H, W)

    def compose_grad():
        p = inputs[0].detach().requires_grad_()
        return torch.autograd.grad(pc.scalar_loss(*compose(p, *inputs[1:])), p)

    def full_loss(*a):
        rgb, alpha = rasterize(*a[:5], scene[5], scene[6], W, H,
                               backgrounds=bg, mode="kernel", tile_shape=tile,
                               chunk=chunk, tile_expand=expand)
        return pc.scalar_loss(rgb, alpha)

    def full_grad():
        ps = [x.detach().requires_grad_() for x in scene[:5]]
        return torch.autograd.grad(full_loss(*ps), ps)

    probe.time("project+sort", lambda: pc.project_sorted(scene, H, W))
    probe.time("+bin+compose fwd", stage_all)
    probe.time("compose fwd", lambda: compose(*inputs))
    probe.time("compose fwd+bwd", compose_grad)
    probe.time("full fwd", lambda: full_loss(*scene[:5]))
    probe.time("full fwd+bwd", full_grad)
    out = probe.result(chunk=chunk, tile=list(tile), expand=expand)
    if record:
        with stages.record(probe.dev) as rec:
            compose_grad()
        out["recording"] = rec
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=20)
    ap.add_argument("chunk", type=int, nargs="?", default=DEFAULT_CHUNK)
    ap.add_argument("tile_h", type=int, nargs="?")
    ap.add_argument("tile_w", type=int, nargs="?")
    ap.add_argument("expand", type=int, nargs="?", default=EXPAND)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--n", type=int, default=N)
    a = ap.parse_args(argv)
    tile = (a.tile_h, a.tile_w) if a.tile_w is not None else DEFAULT_TILE
    return run(a.chunk, tile, a.expand, a.device, a.seed, a.iters, a.height,
               a.width, a.n)


if __name__ == "__main__":
    main()
