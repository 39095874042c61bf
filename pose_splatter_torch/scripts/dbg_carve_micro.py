"""Micro-benchmarks of the carve's constituents at the north-star shape
(counterpart of ``scripts/dbg_carve_micro.py``).

    python -m pose_splatter_torch.scripts.dbg_carve_micro [--device cuda|cpu]
        [--seed N] [--iters N] [--voxels N] [--cameras C] [--height H]
        [--width W]

N = 128·128·64 = 1,048,576 voxels, C = 5 cameras, 576x512 images, the
script's draws in its order (distances in [0.5, 1.5), random pixels, 10 %
and 30 % occupancy). Its items, in its order, each line ms a call
(``probe_common``):

1. lexsort+restore visibility (1 thr): ``ops/carving.py::
   frontmost_visible`` with ``"sort"`` (the core of
   ``ray_cast_visibility``: a stable sort by pixel and distance, the
   unoccupied at +inf, then a permutation scatter back);
2. shared-sort + scan + scatter (1 thr): the script's own alternative,
   written out: the threshold-independent sort, the first occupied voxel
   of each pixel segment by a cumsum and a segmented cummax, a scatter;
3. scatter-min visibility (1 thr): ``frontmost_visible`` with
   ``"segment"`` (the reference's scatter-min; ties all win);
4. sample gather [C,N,3] and [C,N,1] (mask): nearest-pixel gathers;
5. sample gather 128-lane padded: the images padded to 128 channels,
   whole rows gathered, cut to 3 (a layout the card could use too; the
   padded table is [5, 294912, 128] float32, 755 MB, and the gathered
   rows [5, N, 128] before the cut);
7. projection einsum [C,N,3] (item 6 of the script is skipped there);
8. paired vis (BOTH thresholds): ``carving.py::ray_cast_visibility_pair``,
   the carve's own;
9. sample gather [C,N,4] fused;
10. current vis x2 thresholds: item 1 twice.

The result also says whether the visibility variants agree where their
semantics are the same (``agree``): items 1, 2 and 8's first output on
the 10 % set, item 8's second against item 1 on the 30 % set, exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops.carving import (
    frontmost_visible,
    ray_cast_visibility_pair,
)
from pose_splatter_torch.scripts import probe_common as pc

N, C, H, W = 128 * 128 * 64, 5, 512, 576


def inputs(dev, N: int = N, C: int = C, H: int = H, W: int = W,
           seed: int = 0) -> Dict[str, torch.Tensor]:
    """The script's arrays, drawn in its order, on ``dev``."""
    rng = np.random.default_rng(seed)
    a = dict(d=rng.uniform(0.5, 1.5, (C, N)).astype(np.float32),
             idx=rng.integers(0, H * W, (C, N)),
             occ=rng.uniform(size=N) < 0.1,
             imgs=rng.uniform(size=(C, H * W, 3)).astype(np.float32),
             imgs1=rng.uniform(size=(C, H * W, 1)).astype(np.float32),
             pts=rng.normal(size=(N, 3)).astype(np.float32),
             P34=rng.normal(size=(C, 3, 4)).astype(np.float32),
             occ2=rng.uniform(size=N) < 0.3)
    return {k: torch.from_numpy(v).to(dev) for k, v in a.items()}


def vis_shared(d, idx, occ):
    """Item 2 (``dbg_carve_micro.py:51-64``): one sort by (pixel, distance)
    of every voxel; the first occupied voxel of each pixel segment."""
    key = (idx << 32) | d.contiguous().view(torch.int32).long()
    order = torch.sort(key, dim=1, stable=True).indices
    p_s = torch.gather(idx, 1, order)
    occ_s = occ[order].long()
    first = torch.ones_like(p_s, dtype=torch.bool)
    first[:, 1:] = p_s[:, 1:] != p_s[:, :-1]
    excl = torch.cumsum(occ_s, 1) - occ_s
    seg_base = torch.cummax(torch.where(first, excl, torch.full_like(excl, -1)),
                            1).values
    vis_s = (occ_s > 0) & (excl == seg_base)
    return torch.empty_like(vis_s).scatter_(1, order, vis_s)


def sample(imgs, idx):
    """``take_along_axis(imgs, idx[..., None], axis=1)``: [C,HW,ch] → [C,N,ch]."""
    return torch.gather(imgs, 1, idx[..., None].expand(-1, -1, imgs.shape[-1]))


def projection(pts, P34):
    ph = torch.cat([pts, pts.new_ones((pts.shape[0], 1))], 1)
    return torch.einsum("cij,nj->cni", P34, ph)


def run(device="cuda", seed: int = 0, iters: int = 10, N: int = N,
        C: int = C, H: int = H, W: int = W) -> Dict:
    probe = pc.Probe(device, iters, width=38, fmt="9.2f")
    x = inputs(probe.dev, N, C, H, W, seed)
    d, idx, occ, occ2 = x["d"], x["idx"], x["occ"], x["occ2"]
    imgs, imgs1 = x["imgs"], x["imgs1"]
    hw = H * W

    def vis_sort(o):
        return frontmost_visible(d, idx, o, hw, "sort")

    probe.time("lexsort+restore visibility (1 thr)", lambda: vis_sort(occ))
    probe.time("shared-sort + scan + scatter (1 thr)",
               lambda: vis_shared(d, idx, occ))
    probe.time("scatter-min visibility (1 thr)",
               lambda: frontmost_visible(d, idx, occ, hw, "segment"))
    probe.time("sample gather [C,N,3]", lambda: sample(imgs, idx))
    probe.time("sample gather [C,N,1] (mask)", lambda: sample(imgs1, idx))
    imgs_p = torch.cat([imgs, imgs.new_zeros((C, hw, 125))], -1)
    probe.time("sample gather 128-lane padded",
               lambda: sample(imgs_p, idx)[..., :3])
    del imgs_p
    probe.time("projection einsum [C,N,3]",
               lambda: projection(x["pts"], x["P34"]))
    probe.time("paired vis (BOTH thresholds)",
               lambda: ray_cast_visibility_pair(d, idx, occ, occ2))
    imgs4 = torch.cat([imgs, imgs1], -1)
    probe.time("sample gather [C,N,4] fused", lambda: sample(imgs4, idx))
    probe.time("current vis x2 thresholds",
               lambda: (vis_sort(occ), vis_sort(occ2)))
    v1, v2 = ray_cast_visibility_pair(d, idx, occ, occ2)
    ref1, ref2 = vis_sort(occ), vis_sort(occ2)
    agree = dict(shared=bool(torch.equal(vis_shared(d, idx, occ), ref1)),
                 paired_first=bool(torch.equal(v1, ref1)),
                 paired_second=bool(torch.equal(v2, ref2)))
    print(f"visibility variants agree: {agree}", flush=True)
    return probe.result(agree=agree, visible=int(ref1.sum()),
                        visible2=int(ref2.sum()))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=10)
    ap.add_argument("--voxels", type=int, default=N)
    ap.add_argument("--cameras", type=int, default=C)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters, a.voxels, a.cameras, a.height,
               a.width)


if __name__ == "__main__":
    main()
