"""Micro-benchmarks of the carve's constituents at the north-star shape
(counterpart of ``scripts/dbg_carve_micro.py``).

    python -m pose_splatter_torch.scripts.dbg_carve_micro [--device cuda|cpu]
        [--seed N] [--iters N] [--voxels N] [--cameras C] [--height H]
        [--width W] [--shapes]

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
   the carve's own: each pixel's least (distance, voxel index) key over
   each occupied set, by the hand-written kernel ``csrc/
   carve_visibility.cu`` on the card and by its plain version
   (``visibility_pair_ref``, ``scatter_reduce("amin")``) on the CPU (the
   JAX script's item 8 is a sort, a cumsum and a segmented cummax);
9. sample gather [C,N,4] fused;
10. current vis x2 thresholds: item 1 twice.

The result also says whether the visibility variants agree where their
semantics are the same (``agree``): items 1, 2 and 8's first output on
the 10 % set, item 8's second against item 1 on the 30 % set, and item 8
against ``visibility_pair_ref`` on the same device, exactly.

``--shapes`` adds :func:`visibility_shapes`: item 8 at the main path's
three carve shapes (``VIS_SHAPES``) on a ring of 5 cameras, with the
benchmark scene's ellipsoid and with random sets, against its plain
version bit for bit, its ms a call beside the plain version's, its
bound from the function's own bytes and, apart, the fill of the kernel's
scratch table. It then adds :func:`color_shapes`: the exact carve's
colour stage (``carving.py::carve_colors_pair``, ``csrc/carve_colors.cu``
on the card) at the 2D, pigeon_4 and high-res carve shapes
(``COLOR_SHAPES``), each in the layout its carve hands over, against its
plain version (``carve_colors_ref``: an einsum a threshold, a batched gemv
on the card, and its elementwise ops), with the einsums alone beside them
and the bound from the bytes these inputs need. On the card every time is
one call's device ms by CUDA-graph replay (``bench.py::graph_device_ms``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops.carving import (
    _pixel_indices,
    _weights_of,
    carve_colors_pair,
    carve_colors_ref,
    frontmost_visible,
    ray_cast_visibility_pair,
    visibility_pair_ref,
)
from pose_splatter_torch.scripts import probe_common as pc
from pose_splatter_torch.utils.device import call_ms, resolve_device
from pose_splatter_torch.utils.geometry import (
    camera_positions,
    create_3d_grid,
    project_points,
)
from pose_splatter_torch.utils.synthetic import ring_cameras

N, C, H, W = 128 * 128 * 64, 5, 512, 576

# The carve's visibility on the main path: (name, grid size, crop, image
# width, height) of the 2D preset, the 3D preset and the high-res preset,
# each with 5 observed cameras (ell 0.22).
CROP = ((0, 96), (16, 96), (25, 89))
VIS_SHAPES = (("2d_576x512", 128, CROP, 576, 512),
              ("3d_288x256", 112, CROP, 288, 256),
              ("highres_1152x1024", 256, ((0, 192), (32, 192), (50, 178)),
               1152, 1024))
VIS_AXES = (0.0385, 0.0224, 0.0196)  # the benchmark scene's ellipsoid
# The exact carve's colour stage: (name, grid size, crop, image width,
# height, cameras, sampled's layout) of the 2D preset and the high-res
# preset (the fused gather's stride-4 view) and of pigeon_4 (the whole 80³
# cube, 4 cameras, the contiguous [C, N, 3] of the K_mask gather).
COLOR_SHAPES = (("2d_576x512",) + VIS_SHAPES[0][1:] + (5, "view"),
                ("pigeon4_656x320", 80, ((0, 80),) * 3, 656, 320, 4,
                 "contiguous"),
                ("highres_1152x1024",) + VIS_SHAPES[2][1:] + (5, "view"))
NONVISIBLE_WEIGHT, FILL = 0.25, 0.45  # carve_volume's defaults
PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s


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


def visibility_inputs(dev, grid_size: int, crop, width: int, height: int,
                      sets: str = "ellipsoid", cameras: int = 5,
                      seed: int = 0):
    """The carve's visibility pair's arguments (dists, flat, occ1, occ2,
    n_pixels) on ``dev`` for a grid of ``grid_size`` (ell 0.22) cut to
    ``crop``, seen by ``cameras`` ring cameras at width x height (focal
    800 px at 576 wide), as ``carve_volume`` computes them. ``sets``
    "ellipsoid": the benchmark scene's ellipsoid at the crop's centre
    (occ2) and its inner part (occ1, radius² 0.8), nested as the carve's
    thresholds are; "random": 10 % and 30 % of the voxels drawn apart
    from ``seed``, not nested."""
    dev = torch.device(dev)
    Ks, Es = ring_cameras(cameras, width, height, 800.0 * width / 576, 0.6)
    K, E = torch.from_numpy(Ks).to(dev), torch.from_numpy(Es).to(dev)
    pts = torch.from_numpy(
        create_3d_grid(0.22, grid_size, crop).reshape(-1, 3)).to(dev)
    dists = torch.linalg.norm(pts[None] - camera_positions(E)[:, None], dim=-1)
    flat = _pixel_indices(project_points(pts, K, E, clamp_z=True), height,
                          width)[2]
    if sets == "ellipsoid":
        axes = torch.tensor(VIS_AXES, device=dev)
        r2 = (((pts - pts.mean(0)) / axes) ** 2).sum(1)
        occ1, occ2 = r2 <= 0.8, r2 <= 1.0
    elif sets == "random":
        u = torch.from_numpy(np.random.default_rng(seed).uniform(
            size=(2, pts.shape[0]))).to(dev)
        occ1, occ2 = u[0] < 0.1, u[1] < 0.3
    else:
        raise ValueError(f"unknown sets {sets!r}")
    return dists, flat, occ1, occ2, height * width


def visibility_bound(dists, occ1, occ2, n_pixels: int) -> Dict:
    """The pair's least time at the card's memory bandwidth, from the bytes
    the function itself needs, each counted once: the flags, the booleans
    written and the occupied voxels' distances and pixels (``bytes``,
    ``bound_ms``). Apart from them, the fill of the kernel's own scratch
    table of 64-bit keys, ``[2, C, n_pixels]`` (``fill_bytes``,
    ``fill_ms``), a cost of the design and not of the function;
    ``bound_with_fill_ms`` is the two together."""
    cams, n = dists.shape
    occupied = int((occ1 | occ2).sum())
    nbytes = 2 * n + 2 * cams * n + 12 * cams * occupied
    fill = 16 * cams * n_pixels
    return dict(occupied=occupied, bytes=nbytes,
                bound_ms=1e3 * nbytes / PEAK_BYTES, fill_bytes=fill,
                fill_ms=1e3 * fill / PEAK_BYTES,
                bound_with_fill_ms=1e3 * (nbytes + fill) / PEAK_BYTES)


def visibility_shapes(device="cuda", iters: int = 10, seed: int = 0,
                      shapes=VIS_SHAPES, device_timer=None) -> list:
    """Item 8 at each of ``shapes`` with both kinds of sets
    (:func:`visibility_inputs`): bit-equal to ``visibility_pair_ref``,
    ms a call of each (``probe_common``'s timing: CUDA events around
    back-to-back calls on the card) and the bound of
    :func:`visibility_bound`; with ``device_timer`` (a function of a call,
    such as one that replays calls captured in a CUDA graph) also the
    kernel's ``device_ms``. One row a shape and sets."""
    dev = resolve_device(device)
    rows = []
    for name, grid_size, crop, width, height in shapes:
        for sets in ("ellipsoid", "random"):
            x = visibility_inputs(dev, grid_size, crop, width, height, sets,
                                  seed=seed)
            got = ray_cast_visibility_pair(*x)
            ref = visibility_pair_ref(*x)
            row = dict(shape=name, sets=sets, voxels=x[0].shape[1],
                       cameras=x[0].shape[0], pixels=x[4],
                       bit_equal=all(bool(torch.equal(a, b))
                                     for a, b in zip(got, ref)),
                       visible=[int(v.sum()) for v in got],
                       ms=call_ms(lambda: ray_cast_visibility_pair(*x),
                                     dev, iters),
                       plain_ms=call_ms(lambda: visibility_pair_ref(*x),
                                           dev, iters),
                       **visibility_bound(x[0], x[2], x[3], x[4]))
            if device_timer is not None:
                row["device_ms"] = device_timer(
                    lambda: ray_cast_visibility_pair(*x))
            print(f"carve visibility {name} {sets}: {row['voxels']} voxels "
                  f"x {row['cameras']} cameras, {row['occupied']} occupied, "
                  f"visible {row['visible']}; {row['ms']:.4f} ms a call"
                  + (f" ({row['device_ms']:.4f} on the device)"
                     if device_timer is not None else "") + ", "
                  f"plain {row['plain_ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bytes'] / 1e6:.1f} MB), "
                  f"with the table's fill {row['bound_with_fill_ms']:.4f} ms "
                  f"(+{row['fill_bytes'] / 1e6:.1f} MB); "
                  f"bit-equal {row['bit_equal']}", flush=True)
            rows.append(row)
    return rows


def color_inputs(dev, grid_size: int, crop, width: int, height: int,
                 cameras: int = 5, layout: str = "view",
                 sets: str = "ellipsoid", seed: int = 0):
    """The colour stage's arguments (sampled, vis1, vis2, occ1, occ2,
    nonvisible weight, fill) on ``dev``: :func:`visibility_inputs`' sets
    and their visibility pair, and colours uniform in [0, 1) drawn from
    ``seed`` as [C, N, 4] and handed over as the stride-4 view of its
    first three channels (``layout`` "view", the fused gather's) or as a
    contiguous [C, N, 3] ("contiguous", the ``K_mask`` gather's)."""
    dev = torch.device(dev)
    dists, flat, occ1, occ2, P = visibility_inputs(
        dev, grid_size, crop, width, height, sets, cameras, seed)
    vis1, vis2 = ray_cast_visibility_pair(dists, flat, occ1, occ2, P)
    gen = torch.Generator(device=dev).manual_seed(seed)
    samp = torch.rand((cameras, dists.shape[1], 4), generator=gen,
                      device=dev)[..., :3]
    if layout == "contiguous":
        samp = samp.contiguous()
    elif layout != "view":
        raise ValueError(f"unknown layout {layout!r}")
    return samp, vis1, vis2, occ1, occ2, NONVISIBLE_WEIGHT, FILL


def color_bound(sampled, occ1, occ2) -> Dict:
    """The colour stage's least time at the card's memory bandwidth. From
    the bytes these inputs need (``bytes``, ``bound_ms``): every voxel's
    two flags and its [4] float32 volume, and for a voxel of a set that
    set's visibility and, for a voxel of either, its 3 float32 colours,
    each counted once (an unoccupied voxel's colours and visibility do not
    reach the volume). Apart, every input read once whatever the sets
    (``dense_bytes``, ``dense_bound_ms``: ``sampled``'s storage, 16 bytes
    a colour for the stride-4 view)."""
    C, n, _ = sampled.shape
    in1, in2 = int(occ1.sum()), int(occ2.sum())
    either = int((occ1 | occ2).sum())
    nbytes = 18 * n + C * (in1 + in2) + 12 * C * either
    dense = 4 * sampled.stride(1) * C * n + 2 * C * n + 18 * n
    return dict(occupied=either, bytes=nbytes,
                bound_ms=1e3 * nbytes / PEAK_BYTES, dense_bytes=dense,
                dense_bound_ms=1e3 * dense / PEAK_BYTES)


def color_ulps(got: torch.Tensor, want: torch.Tensor) -> Dict:
    """``got`` against ``want`` ([4, N] volumes of non-negative values):
    whether the occupancy channel is equal, and the largest distance in
    units in the last place of the colour channels (their float32 bit
    patterns, which order as the values do)."""
    a, b = got[1:].contiguous(), want[1:].contiguous()
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return dict(occupancy_equal=bool(torch.equal(got[0], want[0])),
                max_ulps=int(ulps.max()) if ulps.numel() else 0)


def color_shapes(device="cuda", iters: int = 10, seed: int = 0,
                 shapes=COLOR_SHAPES, device_timer=None) -> list:
    """The colour stage at each of ``shapes`` with both kinds of sets
    (:func:`color_inputs`): the occupancy equal to ``carve_colors_ref``'s
    and the colours' largest distance from it in ulps
    (:func:`color_ulps`); ms a call of the stage, of its plain version and
    of the plain version's two einsums alone, each by ``device_timer`` (a
    function of a call; on the card by default one call's device ms by
    CUDA-graph replay, on the CPU the host clock); and the bound of
    :func:`color_bound`. One row a shape and sets."""
    dev = resolve_device(device)
    if device_timer is None:
        if dev.type == "cuda":
            from pose_splatter_torch.scripts.bench import graph_device_ms

            def device_timer(fn):
                return graph_device_ms(fn, (), iters)
        else:
            def device_timer(fn):
                return call_ms(fn, dev, iters)
    rows = []
    for name, grid_size, crop, width, height, cameras, layout in shapes:
        for sets in ("ellipsoid", "random"):
            x = color_inputs(dev, grid_size, crop, width, height, cameras,
                             layout, sets, seed)
            samp, vis1, vis2, _, _, nw, _ = x
            w1, w2 = _weights_of(vis1, nw), _weights_of(vis2, nw)

            def einsums():
                return (torch.einsum("cn,cnk->nk", w1, samp),
                        torch.einsum("cn,cnk->nk", w2, samp))

            row = dict(shape=name, sets=sets, layout=layout,
                       voxels=samp.shape[1], cameras=cameras,
                       **color_ulps(carve_colors_pair(*x),
                                    carve_colors_ref(*x)),
                       ms=device_timer(lambda: carve_colors_pair(*x)),
                       plain_ms=device_timer(lambda: carve_colors_ref(*x)),
                       einsum_ms=device_timer(einsums),
                       **color_bound(samp, x[3], x[4]))
            print(f"carve colours {name} {sets} ({layout}): {row['voxels']} "
                  f"voxels x {cameras} cameras, {row['occupied']} occupied; "
                  f"{row['ms']:.4f} ms a call, plain {row['plain_ms']:.4f} "
                  f"ms (its einsums {row['einsum_ms']:.4f}); bound "
                  f"{row['bound_ms']:.4f} ms ({row['bytes'] / 1e6:.1f} MB), "
                  f"every input once {row['dense_bound_ms']:.4f} ms "
                  f"({row['dense_bytes'] / 1e6:.1f} MB); occupancy equal "
                  f"{row['occupancy_equal']}, colours within "
                  f"{row['max_ulps']} ulp", flush=True)
            rows.append(row)
    return rows


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
               lambda: ray_cast_visibility_pair(d, idx, occ, occ2, hw))
    imgs4 = torch.cat([imgs, imgs1], -1)
    probe.time("sample gather [C,N,4] fused", lambda: sample(imgs4, idx))
    probe.time("current vis x2 thresholds",
               lambda: (vis_sort(occ), vis_sort(occ2)))
    v1, v2 = ray_cast_visibility_pair(d, idx, occ, occ2, hw)
    ref1, ref2 = vis_sort(occ), vis_sort(occ2)
    plain = visibility_pair_ref(d, idx, occ, occ2, hw)
    agree = dict(shared=bool(torch.equal(vis_shared(d, idx, occ), ref1)),
                 paired_first=bool(torch.equal(v1, ref1)),
                 paired_second=bool(torch.equal(v2, ref2)),
                 paired_plain=bool(torch.equal(v1, plain[0])
                                   and torch.equal(v2, plain[1])))
    print(f"visibility variants agree: {agree}", flush=True)
    return probe.result(agree=agree, visible=int(ref1.sum()),
                        visible2=int(ref2.sum()))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=10)
    ap.add_argument("--voxels", type=int, default=N)
    ap.add_argument("--cameras", type=int, default=C)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--shapes", action="store_true",
                    help="also item 8 and the colour stage at the main "
                         "path's carve shapes against their plain versions "
                         "(visibility_shapes, color_shapes)")
    a = ap.parse_args(argv)
    out = run(a.device, a.seed, a.iters, a.voxels, a.cameras, a.height,
              a.width)
    if a.shapes:
        out["shapes"] = visibility_shapes(a.device, a.iters, a.seed)
        out["color_shapes"] = color_shapes(a.device, a.iters, a.seed)
    return out


if __name__ == "__main__":
    main()
