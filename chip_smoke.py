#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --gather-only
    python3 chip_smoke.py --record

Builds every CUDA kernel of the port from the sources in the checkout
(``nvcc``, one process a source, and ``g++`` for the native frame decode,
all at once; it fails if a build fails or ptxas reports a spill), then:

1. card: prints the GPU's name and power limit and the build time;
2. dyngather: the probe entry point (``pose_splatter_torch.scripts.
   dbg_dyngather_micro``: ``probe_correct`` on both axes and the three
   probe lines) with both gather wrappers' launches read around it; then,
   at [2304, 128], on both axes for reps 32 and 1 and on the probe's three
   index patterns: the kernel against its plain version bit for bit, the
   path the C entry reports, and its time four ways beside
   ``torch.take_along_dim``'s: (a) host-launched (CUDA events around
   back-to-back calls of ``dyngather.launch``, so the host's Python sets
   it), (b) on the device (200 launches captured in one CUDA graph,
   replayed between CUDA events), (c) the kernel's own duration from
   ``torch.profiler`` (phase 16), and (e) the launch floor, (b) for a
   one-element ``zero_()``;
3. kernel phase: the forward compositor (with and without its ``tbounds``
   store) and the backward compositor on synthetic instance arrays at the
   full-width shape (6 views x 576x512, 16000 Gaussians) in both modes,
   against their plain PyTorch versions, timed with CUDA events;
4. 2D eval slice: the 2D view-anchored eval forward at the repository's
   quality north-star configuration (``configs/templates/tpu_2d.json`` with
   ``view_anchored``: 576x512, grid 128, crop 96x80x64, 6 cameras with
   holdout views [5, 1], 3 U-Nets of base width 8, up to 16000 Gaussians)
   with seeded random weights (PyTorch's default initialisers, kept so the
   scene stays comparable), over synthetic frames of an ellipsoid seen by 6
   cameras: ``render_images_in_memory`` and ``make_eval_step`` through
   the user-facing entry points, with the forward kernel's and the carve's
   visibility kernel's launch counts read around them (the latter held to
   one a frame), then a per-frame breakdown (each forward's visibility
   launches held to one) from the forward's own stage
   marks (``pose_splatter_torch.utils.stages``) and a kernel-vs-plain check
   on the instance arrays that the forward binned, with how the kernel
   spread over the card there (``split_stats``: chunks walked and evaluated
   past a tile's stop, scratch bytes, CUDA launches a call by
   ``torch.profiler``, ms beside the one-block-a-tile kernel's it replaced);
5. 2D train slice: ``train_from_config`` at the same configuration (fresh
   start, lr 1e-4, img_lambda 0.5, ssim_lambda 0.1, batch 1) for K steps on
   synthetic frames, with both kernels' and the carve's visibility kernel's
   launch counts read around it and each step's stages recorded; then
   unrecorded steps, timed whole with the launches read around each (each
   kernel held to one a step); then the backward kernel against its plain
   version on the last step's own instance arrays, ``tbounds`` and loss
   gradient;
6. 3D eval and 3D train: the same two phases for the 3D Gaussian model,
   ``configs/templates/tpu_3d.json`` as written (288x256, grid 112, crop
   96x80x64, 6 cameras, holdout views [5, 1], 3 U-Nets of base width 8, up
   to 16000 Gaussians; lr 1e-4, img_lambda 0.5, ssim_lambda 0): projection,
   depth sort and both compositors in conic mode;
7. multi-step, after each train phase (2D and 3D): the train phase's
   state through ``make_train_multi_step`` (8 steps a call, one captured
   train step replayed): a warm-up call, a copy into a twin model, then 8
   graph-replayed steps against 8 eager ``make_train_step`` steps of the
   twin, every loss and the final weights compared; the compositor
   launches as replays x launches a captured step (the wrappers count at
   the capture); ms a step both ways; the selection's table flag;
8. bench: ``python -m pose_splatter_torch.scripts.bench``'s lines (the
   counterpart of ``bench.py``: 3D and 2D at 576x512 with 16000 Gaussians
   on its seed-0 scenes, the 3D one ``bench.py::run_3d``'s cluster at
   f = 900) in ``"kernel"`` mode and in ``"tiled"`` mode (the route
   ``bench.py`` takes off the TPU; fewer calls, and its lines say so):
   ``value`` by the host clock and ``device_ms`` by replaying one captured
   fwd+bwd, then the compositor launches of one more fwd+bwd, its stages
   recorded; in kernel mode both compositors against their plain versions
   on the arrays that fwd+bwd binned, and in 3D both alone on them
   (``split_stats``);
9. tiled: the O(P) ``composite_pixels`` against autograd through its scan
   at a (64, 128) tile of 4096 Gaussians (forward bit for bit, gradients
   within 1e-5, both peak memories); the 2D north-star configuration in
   ``"tiled"`` mode (an eval forward of one frame over 6 views, 3 train
   steps, overflow, peak memory); ``graft_entry.entry()`` against its
   ``fn`` on the CPU (1e-4) and its ms a call;
10. synth: ``python -m pose_splatter_torch.scripts.synthetic_benchmark`` at
   ``SYNTH_BENCH.json``'s shape (576x512, grid 128, crop 96x80x64, 6
   cameras, view-anchored 2D) for 64 steps, 8 a call, with the per-camera
   evaluation: its report printed and checked, its state saved;
10a. temporal: ``python -m pose_splatter_torch.scripts.temporal_benchmark``
   on the synth phase's state: (a) its default mode over 600 frames (cut
   from 3600), the held-out PSNR against the synth phase's, the
   forward-kernel launches (one a frame) and the kernel against its plain
   version on a sequence frame's binned arrays; (b) its end-to-end loop
   (``run_sequence``) over 600 frames through ``FrameDataset`` and the
   native decode, from ``images.h5`` where h5py exists and else from a
   uint8 array in memory, PNGs where PIL exists, an MP4 where ffmpeg does,
   the ``mode`` string naming what was paid; (c) the card's busy share
   over 16 sequence frames (phase 17);
10b. input: ``python -m pose_splatter_torch.scripts.dbg_input_pipeline``'s
   measurement at its full width (48 frames, 30 steps, 4 loader threads;
   the frames stored as in (b)): loader alone, eager step alone, the two
   overlapped, both compositors' launches, a frame's decode native against
   NumPy;
10c. doctor: ``python -m pose_splatter_torch.scripts.doctor`` in a
   subprocess exits 0;
11. carve_cap: ``carve_volume`` at the 2D north star's crop (491,520
   voxels): the occupied counts, the carve timed exact, with a cap that
   fits and with the cap N/8 = 61,440 (host-launched, and on the device by
   CUDA-graph replay), each overflow; the
   fitting cap within 1e-6 of the exact carve; the visibility kernel
   (``csrc/carve_visibility.cu``): one launch a carve, exact and capped,
   then at the main path's three carve shapes (``dbg_carve_micro.
   visibility_shapes``: 491,520 voxels at 576x512 and at 288x256,
   3,932,160 at 1152x1024, 5 cameras, the ellipsoid's sets and random
   ones) bit for bit against its plain version, its ms host-launched and
   on the device (CUDA-graph replay) beside the plain version's, its
   bound from the function's own bytes and that bound with the scratch
   table's fill; an eval forward with the fitting cap against none;
   ``make_train_multi_step`` with the cap N/8 against eager steps (as
   phase 7);
12. adaptive3d: ``configs/baseline/pigeon_4.json`` as written (4 cameras
   at 656x320, grid 80, crop 80^3, 3D, adaptive camera): ``train_from_
   config`` for 6 steps, 3 steps timed whole, ``render_images_in_memory``
   over 3 frames, the launches, both compositors against their plain
   versions on one adaptive step's arrays, each frame's ``temp_K`` shift;
13. remat2d: ``configs/templates/tpu_2d_highres.json`` as written
   (1152x1024, grid 256, crop 192x160x128): twin models with and without
   ``remat_unets`` from the same weights, 2 deterministic steps compared
   (1e-6 relative), 2 steps timed whole with the peak device memory above
   the phase's start, both compositors against their plain versions on a
   remat step's arrays (the backward against float64 where its columns
   cancel);
14. bridge: the 2D train phase's state to the JAX payload tree (inverse
   bridge, Adam converter) and back, bit-equal; a step resumed from the
   converted checkpoint file equals one from the original;
15. preprocess: at ``configs/templates/tpu_3d.json``'s full width, (a)
   ``calculate_visual_features`` with the 3D train phase's weights over 6
   frames (the rig at L = 3: 32 views of 224x224, one forward-kernel
   launch a frame): ms a frame, the launches, peak memory, the stages
   from the code's own marks, the rig's overflow, the forward kernel
   against its plain version on the rig's binned arrays, ResNet18 on the
   32 renders card against CPU; (b) ``_carve_moments_batch`` and
   ``_occupancy_batch`` on 16 frames of 4 views at 288x256, grid 112:
   device ms a batch, card against CPU (occupancy exact); (c) LPIPS with
   random weights on 6 pairs at 288x256, card against CPU;
16. viz_eval: the output layer at full width: (a) ``render_turntable``,
   8 novel views of a frame of the 3D train phase at ``tpu_3d.json``'s
   image size 1152x1024 through intrinsics at ``ds = 1`` (one
   forward-kernel launch a view, 1,152 tiles): ms a view, one view's
   stages, the kernel against its plain version on its binned arrays
   with its bound, the instance rows kept and dropped; (b) the
   evaluation's metrics and LPIPS over ``render_images_in_memory``'s
   renders, card against CPU; (c) ``extract_world_gaussians`` card
   against CPU and the four savers; (d) ``profile_model`` on the 2D north
   star with both compositors' launches, and a ``trace`` of one fwd+bwd;
16a. parallel: ``torch.distributed`` in a group of one rank over NCCL
   (made at the phase's start, destroyed at its end): (a) 4 data-parallel
   steps (``make_sharded_train_step``) of the 2D north star from the fresh
   start against 4 of ``make_train_step`` from the same weights, cuDNN
   held to deterministic algorithms, losses and weights bit-equal, ms a
   step each, the compositor launches; (b) 2
   (data = 1, tile = 1) steps of ``make_tile_sharded_train_step`` through
   the ``"kernel"`` compositor on (8, 64) tiles, G = 64, capacity 4096,
   against ``make_train_step`` on a ``"tiled"`` twin at the same tile and
   capacity (loss within 1e-3, equal overflow; the gap to the kernel-mode
   main path printed as information), running statistics unchanged, ms a
   step, peak memory, launches, and both kernels against their plain
   versions on a third step's arrays (the backward within ``bwd_error``'s
   bound or, where the fresh start's crowded tiles cancel, within
   ``bwd_float64_check``'s); (c) ``_composite_local`` on each of
   4 row-aligned shards of the main path's (8, 128) tile grid at the
   north star's Gaussians,
   stitched, against one call over every tile (1e-5); (d)
   ``graft_entry.dryrun_multichip(1)``; (e) ``scripts/scaling.py`` (one
   row) and ``scripts/dbg_highres_sharded.py --devices 1 --steps 2`` at
   1152x1024, grid 256;
16b. probes: the stage-attribution probes (``pose_splatter_torch.
   scripts.dbg_dispatch_floor``, ``bench_breakdown``,
   ``dbg_rast_breakdown``, ``dbg_kernel_profile ... full``,
   ``dbg_vmap_kernel``, ``dbg_gather_bwd``, ``dbg_bin_micro``,
   ``dbg_carve_micro``, ``dbg_model_breakdown``, ``dbg_step_bisect``),
   each ``main`` at its full default shape with both compositors'
   launches read around it (held to the count its lines make), every
   line kept; the checks: ``dbg_vmap_kernel``'s parity, the two backward
   forms of ``dbg_gather_bwd`` ``allclose``, the carve micro's visibility
   variants equal where their semantics are (items 1, 2 and 8 on one
   set, 8 and 1 on the other), both compositors against their plain
   versions on the arrays ``bench_breakdown``'s recorded fwd+bwd binned
   (``bench_kernels``), and ``ray_cast_visibility`` on the card against
   the CPU, both methods, bit for bit on an exact 32^3 grid;
17. profiled: what ``torch.profiler`` measures, deferred to after every
   timed phase: the gather kernel's duration, each compositor call's
   device operations and their device time (``split_stats``), and the
   card's busy share of one more train step in each mode, of a K-step
   call beside an eager step, of a bench-shape fwd+bwd and of 16
   frames of the temporal sequence (``device_busy``).

``--record`` builds the compositors and the native decode and writes the
numbers kept in the repository into ``chiprun_out/``: the synthetic
benchmark for 3000 steps, the temporal benchmark over 3600 frames in both
modes (``TEMPORAL_torch.json``, ``TEMPORAL_torch_e2e.json``), the busy
share over 64 sequence frames, the input probe
(``INPUT_PIPELINE_torch.json``) and a frame's decode, each file with the
card's name and power limit.

``--gather-only`` builds ``dyngather.cu`` alone and runs phases 2 and 17
for the gather. It prints the gather rows and the card, not the final
``ok`` line. The script measures the port of the tree it sits in, so a
copy of it placed at the root of another commit's checkout measures that
commit's kernel the same way.

Prints one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no CUDA device or any phase fails. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H, W, N_GAUSS, VIEWS = 512, 576, 16000, 6
H3, W3 = 256, 288  # the 3D configuration's render size
TOL = 1e-5  # kernel vs plain: same math, sums in another order (see below)
# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Least float32 operations the compositor needs per (instance, pixel) pair,
# in either mode, an FMA counted as two and expf as one: dx, dy (2); the
# quadratic form dx*(P*dx + Q*dy) + R*dy*dy with per-row coefficients (7);
# expf and the opacity (2); contrib = a*T (1); the rgb and alpha sums (7);
# T -= contrib (1). Per-row set-up and comparisons are left out, so this
# is a floor (the kernel's loop does 27 in ellipse mode, see its source).
OPS_PER_PAIR = 20
# The least float32 operations the backward compositor needs per (instance,
# pixel) pair, counted the same way. Recomputing a and T: the forward's 20
# less the 7 rgb/alpha sums = 13. Then w = <g_rgb, rgb> + g_alpha (6); the
# suffix S += w*contrib (2); dL/da = w*T - S/(1 - a), 1 - a kept (3); the
# colour gradients sum(g_c*contrib) (6); the opacity's sum(e*dL/da) (2);
# g = -a*dL/da, the chain into the quadratic form (1); its three
# coefficients' gradients g*dx^2, g*dx*dy, g*dy^2, summed, dy^2 reused
# (2 + 3 + 3 = 8); the mean's two gradients from dq/ddx = (P dx + Q dy) +
# P dx and dq/ddy = Q dx + 2R dy, times g, summed (1 + 3 + 2 + 2 = 8).
# 13 + 6 + 2 + 3 + 6 + 2 + 1 + 8 + 8 = 49. Per-row chains (from the
# quadratic form's coefficients to cos, sin, sx, sy) are left out.
OPS_PER_PAIR_BWD = 49
EPS32 = 2.0 ** -24  # float32 unit roundoff
# The gather's device time: launches captured in one CUDA graph, replays
# of it timed (``graph_ms``).
GRAPH_LAUNCHES = 200
GRAPH_REPLAYS = 10
# Train slices: steps driven through train_from_config, then steps timed
# whole outside any recording.
K_STEPS = 8
K_EXTRA = 3
K_STEPS_3D = 6
EXTRA_PASSES = 3  # passes over the K_EXTRA frames timed whole
# Multi-step phases: steps a call, and the graph-replayed steps' losses
# against the eager steps' (relative to the largest loss).
MS_K = 8
MS_LOSS_RTOL = 1e-5
# The carve-cap phase: frames, CUDA-event iterations a carve, and the
# tolerance of the capped carve (a [C, M] colour einsum reduces otherwise
# than the [C, N] one; the JAX package's own tests hold it within 1e-6)
# and of the eval forward with and without the cap (the CPU parity bar).
CAP_FRAMES = 4
CAP_ITERS = 10
VIS_ITERS = 20  # calls a timing of the visibility kernel (and its plain version)
CAP_TOL = 1e-6
CAP_FWD_TOL = 1e-4
# The adaptive phase: pigeon_4.json's 4 cameras; an ellipsoid off the crop's
# centre that fits its 80 mm crop.
CAMERAS_PIGEON = 4
PIGEON_OFFSET = (0.006, -0.004, 0.003)
PIGEON_AXES = (0.025, 0.015, 0.013)
# The remat phase: losses and weights after 2 steps with and without remat,
# relative to each tensor's largest entry.
REMAT_RTOL = 1e-6
# The preprocess phase: frames of the features pass and the rig's order
# (L = 3: 32 views), ResNet18 card against CPU relative to the largest
# feature, the carves' batch and moment tolerance, LPIPS card against CPU.
PRE_FRAMES = 6
PRE_L = 3
PRE_FEAT_REL = 1e-4
PRE_BATCH = 16
PRE_RTOL = 1e-5
PRE_RTOL_LPIPS = 1e-4
# The viz/eval phase: novel views a turntable at the full image size, the
# evaluation's metrics and LPIPS card against CPU (relative), the export's
# parameters card against CPU (relative to each array's largest), and the
# timing iterations of profile_model.
NOVEL_VIEWS = 8
EVAL_RTOL = 1e-5
EXPORT_TOL = 1e-5
PROFILE_ITERS = 5
# The temporal phase: frames of the sequence in each mode (cut from the
# JAX script's 3600 for the run's time), frames under the profiler, the
# rows the end-to-end loop cycles over (the JAX script's --disk-frames), and
# how far the sequence's held-out PSNR may sit from the synth phase's
# evaluation of the same state (report values, rounded to 0.01 dB alike).
SEQ_FRAMES = 600
SEQ_BUSY_FRAMES = 16
SEQ_DISK_FRAMES = 360
SEQ_PSNR_TOL = 1e-3
# The input phase: the probe's own defaults.
INPUT_FRAMES, INPUT_STEPS, INPUT_WORKERS = 48, 30, 4
# The parallel phase: data-parallel steps against plain ones (bit-equal at
# one rank), the tile step's tile, chunk and capacity (the "tiled" mode's
# TILE_CAPACITY) and steps, its loss against the tiled reference (the JAX
# dry run's 1e-3), the simulated ranks of the rank-local kernel and the
# stitched render's tolerance against the whole one. The tile step's tile
# divides the 576x512 image: the JAX tile step (kept) counts the pixels of
# a partial tile outside the image in its losses (ROADMAP C.21), so only
# such a tile makes it the unsharded step's loss.
PAR_DP_STEPS = 4
PAR_TILE, PAR_G, PAR_CAPACITY, PAR_TILE_STEPS = (8, 64), 64, 4096, 2
PAR_TILE_RTOL = 1e-3
PAR_SHARDS = 4
PAR_STITCH_TOL = 1e-5


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    from pose_splatter_torch.utils.device import card_line as line

    return line("cuda")


# ----------------------------------------------------------------------------
# Timing and bounds.
# ----------------------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    from pose_splatter_torch.utils.device import cuda_ms as timed

    return timed(fn, iters, warmup)


def kernel_bound(astarts, counts, jstop, tile_shape, G):
    """Least time on an H100 for the compositor's work on these inputs:
    the instance rows it walks (each read once, 64 bytes) and its outputs
    written once, against (instance, pixel) pairs at float32 peak."""
    import torch

    P = tile_shape[0] * tile_shape[1]
    counts = counts.long()
    walked = int(torch.minimum(counts, jstop.long() * G).sum())
    T = counts.numel()
    nbytes = walked * 64 + T * (4 + 4 + 8) + T * P * 16 + T * 4
    ops = walked * P * OPS_PER_PAIR
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    # The longest segment (in chunks) is reported beside the busy tiles: it
    # set the time of the earlier one-block-a-tile kernel, which walked a
    # tile's segment in one block. The kernel spreads a tile's chunks over
    # blocks now; only its scans still walk a segment in order.
    return dict(walked_rows=walked, bytes=nbytes, ops=ops,
                busy_tiles=int((counts > 0).sum()),
                max_tile_chunks=int(((counts + G - 1) // G).max()),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def bwd_bound(inst, astarts, counts, jstop, tile_shape, G):
    """Least time on an H100 for the backward compositor's work on these
    inputs: the walked instance rows and their chunks' tbounds rows read
    once, the pixel gradients (g_rgb, g_alpha) and per-tile scalars read
    once, the instance-gradient array written once; against
    OPS_PER_PAIR_BWD float32 operations a walked (instance, pixel) pair."""
    import torch

    P = tile_shape[0] * tile_shape[1]
    counts = counts.long()
    walked = int(torch.minimum(counts, jstop.long() * G).sum())
    chunks = int(jstop.long().sum())
    T = counts.numel()
    nbytes = (walked * 64 + chunks * P * 4 + T * P * 16 + T * 20
              + inst.shape[0] * 64)
    ops = walked * P * OPS_PER_PAIR_BWD
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return dict(walked_rows=walked, walked_chunks=chunks, bytes=nbytes,
                ops=ops, busy_tiles=int((counts > 0).sum()),
                max_tile_chunks=int(jstop.max()),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def device_events(prof):
    """The device operations (kernels, memsets, copies) a profile saw."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events()
            if getattr(ev, "device_type", None) == DeviceType.CUDA]


def profile_call(fn, reps: int = 3):
    """The CUDA kernels (and memsets) one call of ``fn`` runs on the card,
    with their device time, from ``torch.profiler`` over ``reps`` calls
    after a warm-up call: ``{"per_call": n, "kernels": {name: [count a
    call, device us a call]}}``, or None where the profiler saw nothing
    on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in device_events(prof):
        name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
        k = kernels.setdefault(name[:60], [0.0, 0.0])
        k[0] += 1 / reps
        k[1] += ev.time_range.elapsed_us() / reps
    if not kernels:
        return None
    return dict(per_call=round(sum(k[0] for k in kernels.values()), 3),
                kernels=kernels)


def device_busy(fn, count=("fwd_sum", "bwd_grad")):
    """Wall ms of one call of ``fn`` under ``torch.profiler`` (ending in a
    synchronize) and the ms its device operations took (one stream, so
    they do not overlap): how far the host holds the card back. Also how
    many device operations' names hold each of ``count`` (the compositors'
    last kernels: one a forward, one a backward), which counts kernels that
    a CUDA graph replays, where the wrappers' counters do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    evs = device_events(prof)
    busy = sum(ev.time_range.elapsed_us() for ev in evs) / 1e3
    return dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                kernels=len(evs),
                counted={c: sum(c in ev.name for ev in evs) for c in count})


# CUDA-event ms of the one-block-a-tile compositors that the chunk-parallel
# ones replaced, on the main-path arrays, two runs each as PERF.md section 6
# records them (H100 80GB HBM3, 700 W), printed beside this run's.
ONE_BLOCK_A_TILE_MS = {
    ("eval2d", "composite_fwd"): (5.4803, 5.5510),
    ("train2d", "composite_fwd"): (3.0326, 3.0327),
    ("train2d", "composite_bwd"): (19.5362, 19.5358),
    ("eval3d", "composite_fwd"): (5.4285, 5.5898),
    ("train3d", "composite_fwd"): (4.6496, 4.6494),
    ("train3d", "composite_bwd"): (22.6759, 22.6276),
}


def split_stats(cell, kernel, n_rows, counts, jstop, tile_shape, G, ms,
                bound_ms, fn, later):
    """How a compositor call on a main-path array set spread over the
    card: the array's chunks, the chunks walked, the chunks the forward's
    products evaluated past a tile's stop, the scratch, the CUDA launches a
    call, and its ms beside the one-block-a-tile kernel's and the bound.
    The launches come from ``profile_call`` in a closure appended to
    ``later``, which fills them in and prints the line once every timed
    phase has run."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K

    steps = (counts.long() + G - 1) // G
    walked = int(torch.minimum(jstop.long(), steps).sum())
    past = int(steps.sum()) - walked if kernel == "composite_fwd" else 0
    out = dict(
        chunks=n_rows // G, walked_chunks=walked, past_jstop_chunks=past,
        past_jstop_share=past / max(walked, 1),
        scratch_bytes=K.scratch_bytes(n_rows, counts.numel(), G, tile_shape,
                                      backward=kernel == "composite_bwd"),
        launches_per_call=None, kernels=None,
        ms=ms, one_block_ms=ONE_BLOCK_A_TILE_MS.get((cell, kernel)),
        bound_ms=bound_ms)

    def profiled():
        prof = profile_call(fn)
        if prof:
            out.update(launches_per_call=prof["per_call"],
                       kernels=prof["kernels"])
        phases = ("; ".join(f"{n} x{c:g} {us:.1f} us" for n, (c, us) in
                            prof["kernels"].items()) if prof else
                  "not measured")
        before = ("n/a" if out["one_block_ms"] is None
                  else " / ".join(f"{x:.4f}" for x in out["one_block_ms"]))
        print(f"[{cell}] {kernel} split: {out['chunks']} chunks in the "
              f"array, {walked} walked, {past} evaluated past jstop "
              f"({100 * out['past_jstop_share']:.1f} % of the walked), "
              f"scratch {out['scratch_bytes'] / 1e6:.2f} MB, CUDA launches a "
              f"call {out['launches_per_call']} ({phases}) | {ms:.4f} ms, "
              f"one block a tile {before} ms, bound {bound_ms:.4f} ms",
              flush=True)

    later.append(profiled)
    return out


def bwd_error(got, ref, jstop, tile_shape, G):
    """Largest |kernel - plain| of each gradient column over the column's
    largest |plain| entry, and the tolerance: each entry is a sum over the
    tile's P pixels of terms that carry a suffix sum over up to all the
    tile's walked rows, added in another order on each side; a random walk
    of float32 roundings over P * rows terms grows as EPS32 * sqrt(P *
    rows), taken 4 times for the two passes and the cancellation in the
    conic d(A, B, C) columns."""
    P = tile_shape[0] * tile_shape[1]
    rows = max(int(jstop.max()) * G, 1)
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    rel = float(((got - ref).abs().amax(dim=0) / scale).max())
    return rel, 4 * EPS32 * (P * rows) ** 0.5


def bwd_float64_check(tag, d, d_ref, bargs, tol):
    """Where the kernel's backward is farther from its float32 plain
    version than ``bwd_error``'s bound, hold both against the plain
    version run in float64: each column's error is a sum of float32
    roundings of the terms, which the bound scales by the column's largest
    result; where the terms cancel (dL/da = w·T − S/(1 − a) over many
    Gaussians stacked on one spot, say), the result is far smaller than
    the terms and so is the bound. The kernel passes if no column of it is
    farther from the float64 result than twice the float32 plain
    version's distance plus the bound; it fails otherwise."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K

    args64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                   else x for x in bargs)
    d64 = K.composite_instances_bwd_ref(*args64)
    scale = d64.abs().amax(dim=0)
    ek = (d.double() - d64).abs().amax(dim=0)
    ep = (d_ref.double() - d64).abs().amax(dim=0)
    bad = ek > 2 * ep + tol * scale
    cols = [i for i in range(d.shape[1]) if float(scale[i]) > 0]
    print(f"[{tag}] composite_bwd against its plain version in float64, by "
          f"column (largest |exact|, kernel's and float32 plain's largest "
          f"error): " + "; ".join(
              f"{i}: {float(scale[i]):.3g}, {float(ek[i]):.3g}, "
              f"{float(ep[i]):.3g}" for i in cols), flush=True)
    if bool(bad.any()):
        raise AssertionError(f"[{tag}] backward kernel disagrees with the "
                             f"float64 plain version in columns "
                             f"{torch.nonzero(bad).reshape(-1).tolist()}")
    return dict(exact_scale=scale.tolist(), kernel_err=ek.tolist(),
                plain32_err=ep.tolist())


# ----------------------------------------------------------------------------
# Phases.
# ----------------------------------------------------------------------------

def kernel_phase(report):
    """Both modes at the full-width shape on synthetic Gaussians."""
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    results = {}
    for mode in ("ellipse", "conic"):
        def rnd(*shape):
            return torch.rand(*shape, generator=gen).to(dev)

        # Gaussians clustered on the middle of the image, as an animal's are;
        # the conic scene is a denser band, so whole tiles reach T < 1e-4
        # and stop early.
        x0, xw, y0, yw = ((0.25, 0.5, 0.2, 0.6) if mode == "ellipse"
                          else (0.15, 0.7, 0.35, 0.3))
        means = torch.stack([W * (x0 + xw * rnd(VIEWS, N_GAUSS)),
                             H * (y0 + yw * rnd(VIEWS, N_GAUSS))], -1)
        colors = rnd(N_GAUSS, 3).expand(VIEWS, -1, -1)
        valid = torch.ones((VIEWS, N_GAUSS), dtype=torch.bool, device=dev)
        if mode == "ellipse":
            scales = 1.0 + 3.0 * rnd(N_GAUSS, 2)
            opac = 0.2 + 0.75 * rnd(N_GAUSS)
            radius = 3.0 * scales.amax(1)
            packed = K.pack_ellipse(
                means, scales.expand(VIEWS, -1, -1),
                (6 * rnd(N_GAUSS) - 3).expand(VIEWS, -1),
                opac.expand(VIEWS, -1), colors, radius.expand(VIEWS, -1))
        else:
            # Conic = inverse 2D covariance of sigmas 1.5-5.5 px.
            sig = 1.5 + 4.0 * rnd(N_GAUSS, 2)
            th = 6 * rnd(N_GAUSS) - 3
            c, s = torch.cos(th), torch.sin(th)
            ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
            conic = torch.stack([c * c * ia + s * s * ib, c * s * (ia - ib),
                                 s * s * ia + c * c * ib], -1)
            opac = 0.6 + 0.39 * rnd(N_GAUSS)
            radius = 3.0 * sig.amax(1)
            packed = K.pack_conic(means, conic.expand(VIEWS, -1, -1),
                                  opac.expand(VIEWS, -1), colors,
                                  radius.expand(VIEWS, -1))
        b = R.bin_instances(packed, means, radius.expand(VIEWS, -1), valid,
                            H, W, R.DEFAULT_TILE, R.DEFAULT_CHUNK, 16)
        args = (b.inst, b.astarts, b.counts, b.origins, R.DEFAULT_TILE,
                R.DEFAULT_CHUNK, mode)
        got = K.composite_instances(*args)
        ref = K.composite_instances_ref(*args)
        torch.cuda.synchronize()
        err = max(float((got[0] - ref[0]).abs().max()),
                  float((got[1] - ref[1]).abs().max()))
        jstop_equal = bool(torch.equal(got[2], ref[2]))
        ms = cuda_ms(lambda: K.composite_instances(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: K.composite_instances_ref(*args), iters=2)
        bound = kernel_bound(b.astarts, b.counts, got[2], R.DEFAULT_TILE,
                             R.DEFAULT_CHUNK)
        n_steps = (b.counts.long() + R.DEFAULT_CHUNK - 1) // R.DEFAULT_CHUNK
        r = dict(mode=mode, tiles=int(b.counts.numel()),
                 sum_counts=int(b.counts.long().sum()),
                 overflow=int(b.overflow), max_abs_err=err,
                 jstop_equal=jstop_equal,
                 tiles_stopped_early=int((got[2].long() < n_steps).sum()),
                 ms=ms, plain_ms=plain_ms, **bound)
        print(f"kernel[{mode}]: tiles {r['tiles']} sum(counts) {r['sum_counts']} "
              f"rows walked {r['walked_rows']} early-stopped tiles "
              f"{r['tiles_stopped_early']} | max|kernel-plain| {err:.3g} "
              f"(tol {TOL}) jstop equal {jstop_equal} | kernel {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['ops'] / 1e9:.3f} GFLOP, "
              f"{r['bytes'] / 1e6:.2f} MB) | {r['busy_tiles']} busy tiles, "
              f"longest segment {r['max_tile_chunks']} chunks", flush=True)
        if not err <= TOL:
            raise AssertionError(f"{mode}: kernel disagrees with plain ({err})")
        if mode == "conic" and not jstop_equal:
            raise AssertionError("conic: jstop differs from the plain version")
        if mode == "conic" and r["tiles_stopped_early"] == 0:
            raise AssertionError("conic: no tile stopped early, so the stop "
                                 "was not exercised")
        if not torch.isfinite(got[0]).all() or not torch.isfinite(got[1]).all():
            raise AssertionError(f"{mode}: non-finite kernel output")
        r.update(backward_check(b, mode, gen))
        results[mode] = r
    report["kernel_phase"] = results
    return results


def backward_check(b, mode, gen):
    """The forward's tbounds store and the backward kernel against their
    plain versions on binned instances ``b``, with seeded loss gradients,
    timed with CUDA events."""
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K

    tile, G = R.DEFAULT_TILE, R.DEFAULT_CHUNK
    args = (b.inst, b.astarts, b.counts, b.origins, tile, G, mode)
    got = K.composite_instances(*args, save_tbounds=True)
    ref = K.composite_instances_ref(*args, save_tbounds=True)
    torch.cuda.synchronize()
    # The same entry T as the plain version's chunked product: float32
    # rounding of up to ~140 chunk products of 64 factors each.
    tb_err = float((got[3] - ref[3]).abs().max())
    if not tb_err <= TOL or not torch.equal(got[2], ref[2]):
        raise AssertionError(f"{mode}: tbounds differ from the plain version "
                             f"({tb_err}) or jstop does")
    nt, P = b.counts.numel(), tile[0] * tile[1]
    g_rgb = torch.randn((nt, 3, P), generator=gen).cuda()
    g_alpha = torch.randn((nt, P), generator=gen).cuda()
    bargs = (b.inst, got[3], b.astarts, b.counts, b.origins, got[2], g_rgb,
             g_alpha, tile, G, mode)
    d = K.composite_instances_bwd(*bargs)
    d_ref = K.composite_instances_bwd_ref(*bargs)
    torch.cuda.synchronize()
    rel, tol = bwd_error(d, d_ref, got[2], tile, G)
    out = dict(
        tbounds_max_abs_err=tb_err,
        bwd_max_abs_err=float((d - d_ref).abs().max()), bwd_rel_err=rel,
        bwd_rel_tol=tol,
        bwd_ms=cuda_ms(lambda: K.composite_instances_bwd(*bargs), 20, 2),
        bwd_plain_ms=cuda_ms(lambda: K.composite_instances_bwd_ref(*bargs), 2),
        fwd_ms=cuda_ms(lambda: K.composite_instances(*args), 20, 2),
        fwd_store_ms=cuda_ms(
            lambda: K.composite_instances(*args, save_tbounds=True), 20, 2),
        bwd_bound=bwd_bound(b.inst, b.astarts, b.counts, got[2], tile, G))
    print(f"backward[{mode}]: tbounds max|kernel-plain| {tb_err:.3g} (tol "
          f"{TOL}) | bwd max|kernel-plain| {out['bwd_max_abs_err']:.3g}, "
          f"{rel:.3g} of each column's largest (tol {tol:.3g}) | bwd kernel "
          f"{out['bwd_ms']:.4f} ms, plain {out['bwd_plain_ms']:.2f} ms, bound "
          f"{out['bwd_bound']['bound_ms']:.4f} ms "
          f"({out['bwd_bound']['bound_by']}) | fwd {out['fwd_ms']:.4f} ms, "
          f"with the store {out['fwd_store_ms']:.4f} ms", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{mode}: backward kernel disagrees ({rel} > {tol})")
    if not torch.isfinite(d).all() or not float(d.abs().max()) > 0:
        raise AssertionError(f"{mode}: backward kernel output is not finite "
                             "or all zero")
    return out


def torch_default_weights(net, seed: int = 0):
    """The eval slice's random weights: PyTorch's default initialisers drawn
    on the CPU from ``seed`` in construction order. They are the weights the
    model was built with before its layers took Flax's initialisers, so the
    eval slice renders the scene it always rendered and its numbers stay
    comparable across versions of the port."""
    import copy

    import torch

    cpu = copy.deepcopy(net).cpu()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for mod in cpu.modules():
            if isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d,
                                torch.nn.Linear)):
                mod.reset_parameters()
    net.load_state_dict(cpu.state_dict())


def eval_phase(report, key, config, mode, later):
    """The eval forward of ``config`` through ``render_images_in_memory``
    and ``make_eval_step`` with seeded random weights, then per-frame
    stages and the forward kernel against its plain version (``mode``:
    "ellipse" for 2D, "conic" for 3D) on the forward's own arrays."""
    import torch

    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.ops import carving
    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.evaluate import (
        _batch_metrics,
        render_images_in_memory,
    )
    from pose_splatter_torch.train.loop import make_eval_step
    from pose_splatter_torch.train.losses import total_loss
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.synthetic import FrameSet

    Wc, Hc = config.render_width, config.render_height
    n_frames = 3
    Ks, Es, frames = ring_scene(config, VIEWS, n_frames, seed=0)
    t0 = time.perf_counter()
    model = build_model(config, cameras=(Ks, Es), device="cuda", seed=0)
    torch_default_weights(model.net)
    if model.gaussian_mode == "2d":
        init_means2d_center(model.net, Wc, Hc, anchored=True)
    torch.cuda.synchronize()
    print(f"[{key}] model: {model.gaussian_mode}, {sum(p.numel() for p in model.net.parameters())} parameters, "
          f"crop {model.input_size}, views {model.num_cameras} (observed "
          f"{model.observed_views}), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    data = FrameSet(frames, model.observed_views)
    step = make_eval_step(model, config.img_lambda, config.ssim_lambda)
    # Eval batch: each frame renders one observed view against its target.
    obs_pos = np.arange(n_frames) % len(model.observed_views)
    batch = dict(
        mask=frames["mask"][:, model.observed_views],
        img=frames["img"][:, model.observed_views],
        p_3d=frames["p_3d"], angle=frames["angle"],
        view_idx=np.asarray(model.observed_views)[obs_pos], obs_idx=obs_pos)

    # Warm-up of both entry points (cuDNN algorithm choice for the U-Net and
    # SSIM shapes, allocator) outside the counted and timed run.
    render_images_in_memory(model, FrameSet(
        {k: v[:1] for k, v in frames.items()}, model.observed_views))
    step({k: v[:1] for k, v in batch.items()})
    torch.cuda.synchronize()

    # ---- the main path, with the launch counts zeroed around it ----
    K.composite_instances.launches = 0
    carving.ray_cast_visibility_pair.launches = 0
    t0 = time.perf_counter()
    rgba = render_images_in_memory(model, data)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, metrics = step(batch)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = K.composite_instances.launches
    carve_launches = carving.ray_cast_visibility_pair.launches
    # ---------------------------------------------------------------
    print(f"[{key}] main path: render_images_in_memory {n_frames} frames x "
          f"{VIEWS} views in {1e3 * t_render:.1f} ms, make_eval_step "
          f"{n_frames} frames in {1e3 * t_eval:.1f} ms; composite_fwd "
          f"launches {launches}, carve_visibility {carve_launches}",
          flush=True)
    if launches <= 0:
        raise AssertionError("the main path never launched composite_fwd")
    if carve_launches != 2 * n_frames:  # one carve a frame, in each entry
        raise AssertionError(f"{2 * n_frames} frames made {carve_launches} "
                             "carve_visibility launches")
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"eval step: loss {float(loss):.6f} metrics {metrics}", flush=True)
    if rgba.shape != (n_frames, VIEWS, Hc, Wc, 4):
        raise AssertionError(f"rendered shape {rgba.shape}")
    if not np.isfinite(float(loss)) or not all(np.isfinite(list(metrics.values()))):
        raise AssertionError("non-finite eval loss or metrics")

    gt = torch.as_tensor(frames["img"], device="cuda")
    pred = torch.as_tensor(rgba, device="cuda").float() / 255.0
    sums = _batch_metrics(gt, pred[..., :3], pred[..., 3])
    per_cam = {k: (v / n_frames).tolist() for k, v in sums.items()}
    print(f"per-camera metrics (rendered vs synthetic ground truth): "
          f"{json.dumps(per_cam)}", flush=True)

    # ---- per-frame stage breakdown (same model, same frames) ----
    # Each frame's forward runs plain three times, timed whole, with the
    # first run's launches counted, then once with the forward's own stage
    # marks recorded (each mark synchronises, so the stages add up to more
    # than the whole).
    def sync_ms(t):
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    frames_out = []
    slice_kernel = None
    view_idx = torch.arange(VIEWS, device="cuda")
    obs = model.observed_views[0]
    for i in range(n_frames):
        mask, img, p_3d, angle, _ = data.get(i)
        runs = []
        for r in range(3):
            torch.cuda.synchronize()
            before = (K.composite_instances.launches,
                      carving.ray_cast_visibility_pair.launches)
            t_all = time.perf_counter()
            rgb_e, alpha_e, overflow_e = model(mask, img, p_3d, angle,
                                               view_idx, return_overflow=True)
            runs.append(sync_ms(t_all))
            if r == 0:
                per_forward = K.composite_instances.launches - before[0]
                carve_per_forward = (carving.ray_cast_visibility_pair.launches
                                     - before[1])
        whole = float(np.median(runs))
        with stages.record() as rec:
            model(mask, img, p_3d, angle, view_idx)
        st = {k: sum(v) for k, v in rec.spans.items()}
        g, b = rec.values["select_head"][-1], rec.values["binning"][-1]
        t = time.perf_counter()
        tl, _ = total_loss(rgb_e[obs], alpha_e[obs], model._tensor(img[0]),
                           model._tensor(mask[0]), config.img_lambda,
                           config.ssim_lambda)
        float(tl)
        st["metrics"] = sync_ms(t)
        n_valid = int(g["valid"].sum())
        out = dict(frame=i, whole_forward_ms=whole, whole_forward_runs_ms=runs,
                   stages_ms=st, gaussians_valid=n_valid,
                   gaussians_selected=int(g["valid"].numel()),
                   overflow=int(overflow_e), instances=int(b.counts.long().sum()),
                   kernel_launches_per_forward=per_forward,
                   carve_launches_per_forward=carve_per_forward,
                   loss_view0=float(tl))
        frames_out.append(out)
        print(f"[{key}] frame {i}: forward {whole:.2f} ms (median of "
              f"{', '.join(f'{x:.2f}' for x in runs)}), {per_forward} "
              f"composite_fwd / {carve_per_forward} carve_visibility "
              f"launch(es) | "
              + " ".join(f"{k} {v:.2f}" for k, v in st.items())
              + f" ms | gaussians {n_valid}/{g['valid'].numel()} overflow "
              f"{int(overflow_e)} instances {out['instances']} | loss(view "
              f"{obs}) {float(tl):.5f}", flush=True)
        if not torch.isfinite(rgb_e).all() or not torch.isfinite(alpha_e).all():
            raise AssertionError("non-finite render")
        if per_forward <= 0:
            raise AssertionError("the forward never launched composite_fwd")
        if carve_per_forward != 1:
            raise AssertionError(f"a served frame launched carve_visibility "
                                 f"{carve_per_forward} times")
        if i == 0:
            # The kernel against its plain version on the instance arrays
            # that the forward itself binned.
            args = (b.inst, b.astarts, b.counts, b.origins, R.DEFAULT_TILE,
                    R.DEFAULT_CHUNK, mode)
            rgb_t, alpha_t, jstop = K.composite_instances(*args)
            ref = K.composite_instances_ref(*args)
            err = max(float((rgb_t - ref[0]).abs().max()),
                      float((alpha_t - ref[1]).abs().max()))
            if not torch.equal(jstop, ref[2]):
                raise AssertionError(f"[{key}] jstop differs from the plain "
                                     "version on the forward's arrays")
            ms = cuda_ms(lambda: K.composite_instances(*args), iters=20, warmup=2)
            plain_ms = cuda_ms(lambda: K.composite_instances_ref(*args), iters=2)
            bound = kernel_bound(b.astarts, b.counts, jstop, R.DEFAULT_TILE,
                                 R.DEFAULT_CHUNK)
            # The most loaded tile alone: one block on an otherwise idle card.
            hot = int(b.counts.argmax())
            one = (b.inst, b.astarts[hot:hot + 1].contiguous(),
                   b.counts[hot:hot + 1].contiguous(),
                   b.origins[hot:hot + 1].contiguous()) + args[4:]
            hot_ms = cuda_ms(lambda: K.composite_instances(*one), iters=20,
                             warmup=2)
            split = split_stats(
                CELLS[key], "composite_fwd", b.inst.shape[0], b.counts, jstop,
                R.DEFAULT_TILE, R.DEFAULT_CHUNK, ms, bound["bound_ms"],
                lambda: K.composite_instances(*args), later)
            slice_kernel = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                longest_tile_alone_ms=hot_ms, mode=mode,
                                split=split, **bound)
            print(f"[{key}] main-path composite_fwd ({mode}): max|kernel-plain| {err:.3g} (tol "
                  f"{TOL}); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
                  f"{bound['busy_tiles']} of {b.counts.numel()} tiles hold "
                  f"instances, the longest segment is "
                  f"{bound['max_tile_chunks']} chunks and takes {hot_ms:.4f} ms "
                  f"alone", flush=True)
            if not err <= TOL:
                raise AssertionError(f"main-path kernel disagrees ({err})")
    if frames_out[0]["gaussians_valid"] < N_GAUSS:
        raise AssertionError("selection did not reach max_n")
    report[key] = dict(
        launches=launches, carve_launches=carve_launches,
        carve_launches_per_forward=[f["carve_launches_per_forward"]
                                    for f in frames_out],
        render_ms=1e3 * t_render, eval_step_ms=1e3 * t_eval,
        eval_loss=float(loss), eval_metrics=metrics, per_camera=per_cam,
        frames=frames_out, main_path_kernel=slice_kernel,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        alloc_retries=torch.cuda.memory_stats().get("num_alloc_retries", 0))
    return launches, slice_kernel


def north_star_config(**overrides):
    from pose_splatter_torch.config import Config

    cfg = json.loads((ROOT / "configs" / "templates" / "tpu_2d.json").read_text())
    cfg["gaussian_config"] = dict(cfg["gaussian_config"], view_anchored=True)
    cfg.update(min_n=1024, max_n=N_GAUSS, num_unets=3, base_filters=8)
    cfg.update(overrides)
    config = Config(cfg)
    assert (config.render_width, config.render_height) == (W, H)
    return config


def config_3d(**overrides):
    """``configs/templates/tpu_3d.json`` as written (min_n, max_n, U-Net
    count and width are the model's defaults: 1024, 16000, 3, 8)."""
    config = template_config("configs/templates/tpu_3d.json", **overrides)
    assert config.gaussian_mode == "3d"
    assert (config.render_width, config.render_height) == (W3, H3)
    return config


def template_config(path, **overrides):
    """A configuration file of the repository as written (bar
    ``overrides``)."""
    from pose_splatter_torch.config import Config

    cfg = json.loads((ROOT / path).read_text())
    cfg.update(overrides)
    return Config(cfg)


def ring_scene(config, n_views, n_frames, seed=1, offset=(0.0, 0.0, 0.0),
               axes=(0.055, 0.032, 0.028)):
    """``n_views`` ring cameras at ``config``'s render size and synthetic
    frames of an ellipsoid at the crop's centre (+ ``offset``), as the
    train phases draw them."""
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    Wc, Hc = config.render_width, config.render_height
    Ks, Es = ring_cameras(n_views, Wc, Hc, focal=800.0 * Wc / W, radius=0.6)
    grid = create_3d_grid(config.ell, config.grid_size, config.volume_idx)
    frames = synthetic_frames(Ks, Es, Hc, Wc,
                              grid.reshape(-1, 3).mean(0) + np.asarray(offset),
                              axes, n_frames, seed=seed)
    return Ks, Es, frames


def fresh_start(model):
    """``train_from_config``'s fresh start: near-identity U-Nets and, in 2D,
    the means' and scale's start."""
    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.models.unet3d import init_unet_primary_skip

    init_unet_primary_skip(model.net, in_channels=model.in_channels)
    if model.gaussian_mode == "2d":
        init_means2d_center(model.net, model.W, model.H,
                            anchored=model.view_anchored_2d)


def dyngather_bound(S: int, L: int, reps: int):
    """Least time on an H100 for the repeated gather: the table, the indices
    and the output once each against the reps - 1 float32 adds of every
    element (the first term needs no add)."""
    nbytes = 3 * S * L * 4
    ops = (reps - 1) * S * L
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return dict(bytes=nbytes, ops=ops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def graph_ms(fn, launches: int = GRAPH_LAUNCHES,
             replays: int = GRAPH_REPLAYS) -> float:
    """Device ms a call of ``fn``: ``launches`` calls captured in one CUDA
    graph after a warm-up call, the graph replayed ``replays`` times between
    CUDA events, over ``launches * replays``. The host enqueues one graph a
    replay, so the Python of the launch path is not in the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def try_graph_ms(fn, **kw):
    """``(graph_ms(fn, **kw), None)``, or ``(None, why)`` where the capture
    refused a launch: the line then says so, and the profiler's time (c)
    stands alone, never in place of this one."""
    import torch

    try:
        return graph_ms(fn, **kw), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f"capture failed: {str(e).splitlines()[0][:160]}"


def profiled_ms(fn, name: str, calls: int = 50):
    """(c): the mean device duration of the kernels whose name holds
    ``name`` over ``calls`` calls of ``fn``, from ``torch.profiler``'s
    ``key_averages()``, in ms a kernel, with their count; (None, 0) where
    the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    count = sum(e.count for e in hits)
    us = sum(e.device_time_total for e in hits)
    return (us / count / 1e3 if count and us else None), count


def fmt_ms(x, digits: int = 5) -> str:
    return "not measured" if x is None else f"{x:.{digits}f} ms"


def dyngather_phase(report, later):
    """The probe entry point with the gather wrappers' launches read around
    it, then, for the four rows (reps 32 and 1, axes 0 and 1, random
    indices) and the probe's three patterns at [2304, 128]: the kernel
    against its plain version (bit for bit), the path it took, and its time
    four ways, beside ``torch.take_along_dim``'s and a launch floor:
    (a) host-launched ms a launch (``cuda_ms`` over ``launch``), (b) device
    ms a launch (``graph_ms``), (c) the kernel's own duration from
    ``torch.profiler`` (deferred to ``later``), (d) (a) and (b) for
    ``torch.take_along_dim`` on a precomputed int64 index, (e) (b) for a
    one-element ``zero_()``."""
    import torch

    from pose_splatter_torch.ops import dyngather as D
    from pose_splatter_torch.scripts import dbg_dyngather_micro as probe

    # ---- the probe's main path, with the launch counts zeroed around it ----
    D.gather_sum.launches = 0
    D.gather.launches = 0
    res = probe.run(seed=0)
    launches = dict(gather_sum=D.gather_sum.launches, gather=D.gather.launches)
    # ---------------------------------------------------------------------
    print(f"[dyngather] main path: probe_correct {res['correct']}, "
          f"launches {launches}", flush=True)
    if not all(res["correct"].values()):
        raise AssertionError("dyngather: probe_correct reported a MISMATCH")
    # probe_correct: one gather an axis; each probe line: one checked call,
    # then the warm-up and timed launches, every one counted.
    expect = dict(gather_sum=3 * (1 + probe.WARMUP + probe.ITERS), gather=2)
    if launches != expect:
        raise AssertionError(f"dyngather: launches {launches}, the probe makes "
                             f"{expect}")

    dev = torch.device("cuda")
    S, L = probe.S, probe.L
    zero = torch.zeros(1, device=dev)
    floor = dict(device_ms=graph_ms(zero.zero_),
                 host_ms=cuda_ms(zero.zero_, 500, 20))
    print(f"[dyngather] (e) launch floor, a one-element zero_(): device "
          f"{floor['device_ms']:.5f} ms a launch (CUDA graph of "
          f"{GRAPH_LAUNCHES} x {GRAPH_REPLAYS}), host-launched "
          f"{floor['host_ms']:.5f} ms", flush=True)
    rng = np.random.default_rng(5)
    # (row, pattern, axis, reps): the table's four rows draw random
    # indices; the probe's three patterns are its own, at its reps.
    cases = [(name, "random", axis, reps)
             for name, reps in (("dyngather_sum", probe.REPS),
                                ("dyngather_once", 1)) for axis in (0, 1)]
    cases += [("probe", "rowbcast" if i == 1 else "random", axis, probe.REPS)
              for i, axis in enumerate((0, 0, 1))]
    rows, patterns = {}, []
    for name, pattern, axis, reps in cases:
        dim = S if axis == 0 else L
        hi = dim - (reps > 1)
        tab = torch.from_numpy(rng.random((S, L), dtype=np.float32)).to(dev)
        idx_np = (rng.integers(0, hi, (S, 1)).repeat(L, 1)
                  if pattern == "rowbcast" else rng.integers(0, hi, (S, L)))
        idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
        r = gather_case(D, tab, idx, f"{name} {pattern}", axis, reps,
                        floor["device_ms"], later)
        r.update(name=name, pattern=pattern)
        if name == "probe":
            patterns.append(r)
        else:
            rows.setdefault(name, {})[axis] = r
    report["dyngather_phase"] = dict(launches=launches, probe=res, rows=rows,
                                     patterns=patterns, launch_floor=floor)
    return launches, rows


def gather_case(D, tab, idx, name, axis, reps, floor_ms, later):
    """One row of the gather phase on ``tab`` and ``idx``: bit-equality,
    the path, (a)-(d), the bound and its share of (b); (c) is appended to
    ``later``."""
    import torch

    S, L = tab.shape
    wrapper = D.gather if reps == 1 else D.gather_sum

    def wrapped():
        if reps == 1:
            return D.gather(tab, idx, axis)
        return D.gather_sum(tab, idx, axis, reps)

    got = wrapped()
    ref = D.gather_sum_ref(tab, idx, axis, reps)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, ref))
    out = torch.empty_like(tab)
    idx_long = idx.long()

    def kernel():
        return D.launch(wrapper, tab, idx, out, axis, reps)

    def library():
        return torch.take_along_dim(tab, idx_long, dim=axis)

    # The path the C entry reports launching (None from a tree whose
    # launch reports none).
    path = kernel()
    torch.cuda.synchronize()
    rerun_equal = bool(torch.equal(out, got))
    device_ms, capture = try_graph_ms(kernel)
    lib_device_ms, lib_capture = try_graph_ms(library)
    r = dict(
        axis=axis, reps=reps, path=path, bit_equal=equal,
        rerun_bit_equal=rerun_equal,
        max_abs_err=float((got - ref).abs().max()),
        host_ms=cuda_ms(kernel, 500, 20),  # (a)
        device_ms=device_ms, capture=capture,  # (b)
        graph_replayed_launches=(None if device_ms is None else
                                 GRAPH_LAUNCHES * (GRAPH_REPLAYS + 1)),
        profiled_ms=None, profiled_kernels=0,  # (c), filled in later
        # The wrapper, with its index check's read-back.
        wrapper_ms=cuda_ms(wrapped, 100, 5),
        plain_ms=cuda_ms(lambda: D.gather_sum_ref(tab, idx, axis, reps),
                         20, 2),
        library_host_ms=cuda_ms(library, 500, 20),  # (d)
        library_device_ms=lib_device_ms, library_capture=lib_capture,
        launch_floor_ms=floor_ms, **dyngather_bound(S, L, reps))
    r["bound_share"] = None if device_ms is None else r["bound_ms"] / device_ms
    label = f"{name} axis {axis} reps {reps} [{S}, {L}]"
    share = ("" if device_ms is None else
             f" = {100 * r['bound_share']:.1f} % of (b)")
    print(f"[dyngather] {label}: path {path or 'not reported'}, bit-equal "
          f"{equal}, rerun bit-identical {rerun_equal} | (a) host-launched "
          f"{r['host_ms']:.5f} ms, (b) device {fmt_ms(device_ms)}"
          f"{'' if capture is None else ' (' + capture + ')'}, wrapper "
          f"{r['wrapper_ms']:.5f} ms, plain {r['plain_ms']:.4f} ms | (d) "
          f"take_along_dim{' (one gather)' if reps > 1 else ''} (a) "
          f"{r['library_host_ms']:.5f} ms, (b) {fmt_ms(lib_device_ms)} | (e) "
          f"floor {floor_ms:.5f} ms | bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}){share}", flush=True)
    if not (equal and rerun_equal):
        raise AssertionError(f"dyngather {label}: kernel differs from the "
                             "plain version or from its own rerun")
    if path is not None and path != "vector":
        raise AssertionError(f"dyngather {label}: the {path} path ran, not "
                             "the vector one")

    def profiled():
        r["profiled_ms"], r["profiled_kernels"] = profiled_ms(kernel,
                                                              "dyngather")
        print(f"[dyngather] {label}: (c) profiled kernel "
              f"{fmt_ms(r['profiled_ms'])} a launch over "
              f"{r['profiled_kernels']} kernels (device "
              f"{fmt_ms(r['device_ms'])}, host-launched {r['host_ms']:.5f} "
              "ms)", flush=True)

    later.append(profiled)
    return r


def gather_row(dg, launches, name, line):
    """The kernels line's row of one gather wrapper: axis 0's numbers under
    the contract's keys, axis 1's beside them. ``ms`` and ``library_ms``
    (``take_along_dim``, for reps 1 only: with reps > 1 no one call
    computes the function) are host-launched (a), as in every earlier row;
    the device times (b) stand apart under ``device_ms`` and
    ``library_device_ms`` (None where the graph refused the launch), the
    profiler's (c) under ``profiled_ms``."""
    a0, a1 = dg[name][0], dg[name][1]
    once = a0["reps"] == 1

    def lib(r, key):
        return r[key] if once else None

    return dict(
        name=name, route="cuda", source="pose_splatter_torch/csrc/dyngather.cu",
        replaces=f"scripts/dbg_dyngather_micro.py:{line}",
        launches=launches["gather" if once else "gather_sum"],
        max_abs_err=max(a0["max_abs_err"], a1["max_abs_err"]),
        ms=a0["host_ms"], plain_ms=a0["plain_ms"], bound_ms=a0["bound_ms"],
        bound_by=a0["bound_by"], library_ms=lib(a0, "library_host_ms"),
        reps=a0["reps"], ms_axis1=a1["host_ms"],
        library_ms_axis1=lib(a1, "library_host_ms"),
        device_ms=a0["device_ms"], device_ms_axis1=a1["device_ms"],
        profiled_ms=a0["profiled_ms"], profiled_ms_axis1=a1["profiled_ms"],
        library_device_ms=lib(a0, "library_device_ms"),
        library_device_ms_axis1=lib(a1, "library_device_ms"),
        launch_floor_ms=a0["launch_floor_ms"], path=a0["path"],
        path_axis1=a1["path"], plain_ms_axis1=a1["plain_ms"],
        wrapper_ms=a0["wrapper_ms"], wrapper_ms_axis1=a1["wrapper_ms"])


# The bench counterpart's lines: (mode, render_mode) and its timing. Kernel
# mode is timed as bench.py times (best of 4 batches of 30 calls); a tiled
# fwd+bwd takes hundreds of ms on the card, so its lines take fewer calls
# and say so.
BENCH_RUNS = (("3d", "kernel"), ("2d", "kernel"), ("3d", "tiled"),
              ("2d", "tiled"))
BENCH_TIMING = {"kernel": dict(iters=30, reps=4, replays=20),
                "tiled": dict(iters=3, reps=2, replays=3)}


def bench_kernels(tag, rec, later, cancelling=False):
    """Both compositors against their plain versions on the instance
    arrays one bench fwd+bwd binned and the ``tbounds`` and pixel gradients
    its backward got (``rec``): the forward within TOL with ``jstop``
    equal, the backward within ``bwd_error``'s bound, or, for arrays whose
    gradient columns cancel (``cancelling``: the highres fresh start, every
    Gaussian on one pixel), where that bound does not hold, within
    ``bwd_float64_check``'s. In 3D also each alone
    on those arrays, timed with CUDA events, and how it spread over the
    card (``split_stats``)."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K

    bargs = rec.values["kernel_bwd"][0]
    inst, tbounds, astarts, counts, origins, jstop = bargs[:6]
    tile, G, kmode = bargs[8], bargs[9], bargs[10]
    fargs = (inst, astarts, counts, origins, tile, G, kmode)
    fg = K.composite_instances(*fargs, save_tbounds=True)
    fr = K.composite_instances_ref(*fargs, save_tbounds=True)
    d = K.composite_instances_bwd(*bargs)
    d_ref = K.composite_instances_bwd_ref(*bargs)
    torch.cuda.synchronize()
    fwd_err = max(float((x - y).abs().max()) for x, y in
                  ((fg[0], fr[0]), (fg[1], fr[1]), (fg[3], fr[3])))
    rel, tol = bwd_error(d, d_ref, jstop, tile, G)
    out = dict(mode=kmode, rows=int(inst.shape[0]),
               overflow=int(rec.values["binning"][0].overflow),
               fwd_max_abs_err=fwd_err, jstop_equal=bool(torch.equal(fg[2], fr[2])),
               bwd_max_abs_err=float((d - d_ref).abs().max()), bwd_rel_err=rel,
               bwd_rel_tol=tol)
    print(f"[{tag}] on the arrays its fwd+bwd binned ({kmode}, {out['rows']} "
          f"rows, overflow {out['overflow']}): composite_fwd max|kernel-plain| "
          f"{fwd_err:.3g} (tol {TOL}), jstop equal {out['jstop_equal']}; "
          f"composite_bwd max|kernel-plain| {out['bwd_max_abs_err']:.3g}, "
          f"{rel:.3g} of each column's largest (tol {tol:.3g})", flush=True)
    if not fwd_err <= TOL or not out["jstop_equal"]:
        raise AssertionError(f"[{tag}] forward kernel disagrees on the "
                             f"bench's arrays ({fwd_err}) or jstop does")
    if not rel <= tol:
        if not cancelling:
            raise AssertionError(f"[{tag}] backward kernel disagrees on the "
                                 f"bench's arrays ({rel} > {tol})")
        out["float64"] = bwd_float64_check(tag, d, d_ref, bargs, tol)
    if later is not None:
        fwd_ms = cuda_ms(lambda: K.composite_instances(*fargs, save_tbounds=True),
                         20, 2)
        bwd_ms = cuda_ms(lambda: K.composite_instances_bwd(*bargs), 20, 2)
        out["split"] = dict(
            fwd=split_stats(tag, "composite_fwd", inst.shape[0], counts, jstop,
                            tile, G, fwd_ms,
                            kernel_bound(astarts, counts, jstop, tile, G)["bound_ms"],
                            lambda: K.composite_instances(*fargs, save_tbounds=True),
                            later),
            bwd=split_stats(tag, "composite_bwd", inst.shape[0], counts, jstop,
                            tile, G, bwd_ms,
                            bwd_bound(inst, astarts, counts, jstop, tile, G)["bound_ms"],
                            lambda: K.composite_instances_bwd(*bargs), later))
    return out


def bench_phase(report, card, later):
    """``pose_splatter_torch.scripts.bench``'s 3D and 2D lines at 576x512
    with 16000 Gaussians, in ``"kernel"`` mode (the hand-written
    compositors) and in ``"tiled"`` mode (the route ``bench.py`` takes off
    the TPU): ``bench.measure``'s ``value`` (host clock) and ``device_ms``
    (one fwd+bwd captured as a CUDA graph, replayed), then the launches of
    one more fwd+bwd with its stages recorded. In kernel mode both
    compositors are then held against their plain versions on the arrays
    that fwd+bwd recorded (``bench_kernels``), and the card's busy share of
    a 3D fwd+bwd is taken after every timed phase."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.scripts import bench
    from pose_splatter_torch.utils import stages

    out = {}
    for mode, render_mode in BENCH_RUNS:
        tm = BENCH_TIMING[render_mode]
        seconds, device_ms, fn, args = bench.measure(
            mode, 1, render_mode, "cuda", **tm)
        line = bench.result_line(mode, 1, seconds, device_ms)
        torch.cuda.synchronize()
        # ---- the bench path, with the launch counts zeroed around it ----
        K.composite_instances.launches = 0
        K.composite_instances_bwd.launches = 0
        with stages.record() as rec:
            grads = fn(*args)
        torch.cuda.synchronize()
        launches = dict(composite_fwd=K.composite_instances.launches,
                        composite_bwd=K.composite_instances_bwd.launches)
        # ---------------------------------------------------------------
        once = int(render_mode == "kernel")
        if launches != dict(composite_fwd=once, composite_bwd=once):
            raise AssertionError(f"bench {mode} {render_mode}: launches "
                                 f"{launches}")
        if not all(torch.isfinite(g).all() and g.abs().max() > 0
                   for g in grads):
            raise AssertionError(f"bench {mode} {render_mode}: a gradient is "
                                 "not finite or all zero")
        if not (line["value"] > 0 and np.isfinite(device_ms) and device_ms > 0):
            raise AssertionError(f"bench {mode} {render_mode}: {line}")
        note = ("" if render_mode == "kernel" else
                f"; tiled: best of {tm['reps']} batches of {tm['iters']} "
                f"calls (bench.py: 4 of 30), device_ms over "
                f"{tm['replays']} replays")
        print(f"[bench {mode} {render_mode}] {json.dumps(line)}", flush=True)
        print(f"[bench {mode} {render_mode}] host {1e3 * seconds:.3f} ms a "
              f"fwd+bwd, device {device_ms:.4f} ms, launches {launches}"
              f"{note}; {card}", flush=True)
        r = out[f"{mode}_{render_mode}"] = dict(
            line=line, host_ms=1e3 * seconds, device_ms=device_ms,
            launches=launches, timing=tm)
        if render_mode == "kernel":
            r["kernels"] = bench_kernels(f"bench{mode}", rec,
                                         later if mode == "3d" else None)
        if (mode, render_mode) == ("3d", "kernel"):
            busy = r["device_busy"] = {}

            def bench_busy(fn=fn, args=args, busy=busy):
                busy.update(device_busy(lambda: fn(*args)))
                print(f"[bench3d] under torch.profiler the card was busy "
                      f"{busy['busy_ms']:.2f} ms of a {busy['wall_ms']:.2f} "
                      f"ms fwd+bwd", flush=True)

            later.append(bench_busy)
    report["bench_phase"] = out
    return out


def tiled_phase(report, card):
    """(a) ``composite_pixels`` (the O(P) backward) against
    ``composite_pixels_ref`` (autograd through the scan) on the card at a
    (64, 128) tile with its full capacity of 4096 Gaussians, both alpha
    modes: the forward bit for bit, each gradient within 1e-5 of its
    tensor's largest entry, both peak memories; (b) the 2D north-star
    configuration in ``"tiled"`` mode at full width: the eval forward of
    one frame over 6 views and 3 train steps; (c) ``graft_entry.entry()``
    on the card against the same ``fn`` on the CPU, within 1e-4."""
    import torch

    from pose_splatter_torch import graft_entry
    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.loop import create_train_state, make_train_step
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils.synthetic import FrameSet

    dev = torch.device("cuda")
    out = dict(card=card)

    # (a) ----------------------------------------------------------------
    gen = torch.Generator().manual_seed(0)
    n, th, tw = 4096, 64, 128
    yy, xx = torch.meshgrid(torch.arange(th, dtype=torch.float32),
                            torch.arange(tw, dtype=torch.float32),
                            indexing="ij")
    mean = torch.stack([torch.rand(n, generator=gen) * tw,
                        torch.rand(n, generator=gen) * th], 1)
    cases = dict(
        ellipse=((mean, torch.rand(n, 2, generator=gen) * 2 + 0.7,
                  torch.rand(n, generator=gen) * 3,
                  torch.rand(n, generator=gen) * 0.6 + 0.3),
                 R._alpha_ellipse, False, 0.0),
        conic=((mean, torch.rand(n, 3, generator=gen)
                * torch.tensor([0.3, 0.04, 0.3]) + torch.tensor([0.1, -0.02, 0.1]),
                torch.rand(n, generator=gen) * 0.6 + 0.3),
               R._alpha_conic, True, 0.5))
    colors = torch.rand(n, 3, generator=gen).to(dev)
    valid = (torch.rand(n, generator=gen) > 0.1).to(dev)
    w = torch.rand(th * tw, 3, generator=gen).to(dev)
    out["function_vs_ref"] = {}
    for kind, (feats, alpha_fn, early, off) in cases.items():
        xs = (xx.reshape(-1) + off).to(dev)
        ys = (yy.reshape(-1) + off).to(dev)
        res = []
        for fn in (R.composite_pixels, R.composite_pixels_ref):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            f = [x.to(dev).requires_grad_() for x in feats]
            c = colors.clone().requires_grad_()
            rgb, alpha = fn(xs, ys, tuple(f), c, valid, alpha_fn, 32, early)
            ((rgb * w).sum() + (alpha ** 2).sum()).backward()
            torch.cuda.synchronize()
            res.append(([rgb.detach(), alpha.detach()]
                        + [x.grad for x in f] + [c.grad],
                        torch.cuda.max_memory_allocated() - base))
        (got, mem), (ref, ref_mem) = res
        fwd_equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got[2:], ref[2:]))
        out["function_vs_ref"][kind] = dict(
            forward_bit_equal=fwd_equal, grad_rel_err=rel,
            peak_bytes=mem, ref_peak_bytes=ref_mem,
            alpha_max=float(got[1].max()))
        print(f"[tiled] composite_pixels[{kind}] at P={th * tw}, N={n}: "
              f"forward bit-equal {fwd_equal}, gradients {rel:.3g} of each "
              f"tensor's largest (tol 1e-5); peak memory {mem / 1e6:.1f} MB, "
              f"autograd through the scan {ref_mem / 1e6:.1f} MB", flush=True)
        if not fwd_equal or not rel <= 1e-5:
            raise AssertionError(f"composite_pixels[{kind}] disagrees with "
                                 "composite_pixels_ref")

    # (b) ----------------------------------------------------------------
    config = north_star_config(render_mode="tiled")
    Ks, Es, frames = ring_scene(config, VIEWS, 4, seed=1)
    model = build_model(config, cameras=(Ks, Es), device="cuda", seed=0)
    torch_default_weights(model.net)
    init_means2d_center(model.net, W, H, anchored=True)
    obs = model.observed_views
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    frame_ms, overflow = [], []
    for i in range(3):  # frame 0 warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        rgb, alpha, ov = model(frames["mask"][i, obs], frames["img"][i, obs],
                               frames["p_3d"][i], frames["angle"][i],
                               list(range(VIEWS)), return_overflow=True)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t))
        overflow.append(int(ov))
    if rgb.shape != (VIEWS, H, W, 3) or not torch.isfinite(rgb).all():
        raise AssertionError("tiled north star: bad eval forward")
    state = create_train_state(model, config.lr)
    step = make_train_step(model, state.optimizer, config.img_lambda,
                           config.ssim_lambda)
    batches = iter(FrameLoader(FrameSet(frames, obs, seed=2), batch_size=1,
                               shuffle=False, prefetch=0))
    step_ms, losses, step_overflow = [], [], []
    for _ in range(3):
        batch = next(batches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(metrics["total"]))
        step_overflow.append(float(metrics["overflow"]))
    peak = torch.cuda.max_memory_allocated() - base
    launches = (K.composite_instances.launches,
                K.composite_instances_bwd.launches)
    out["north_star_tiled"] = dict(
        frame_ms=frame_ms, eval_overflow=overflow, step_ms=step_ms,
        losses=losses, step_overflow=step_overflow, peak_bytes=peak,
        alpha_max=float(alpha.max()), compositor_launches=launches)
    print(f"[tiled] 2D north star, render_mode tiled: eval forward of one "
          f"frame x {VIEWS} views {', '.join(f'{x:.1f}' for x in frame_ms)} "
          f"ms (frames 0-2), overflow {overflow}; train steps "
          f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, overflow "
          f"{step_overflow}; peak memory {peak / 1e9:.3f} GB above the start; "
          f"compositor kernel launches {launches}", flush=True)
    if not np.isfinite(losses).all() or launches != (0, 0) \
            or not float(alpha.max()) > 0.1:
        raise AssertionError("tiled north star: non-finite loss, a kernel "
                             "launch or an empty image")
    del model, state, step

    # (c) ----------------------------------------------------------------
    fn, args = graft_entry.entry()
    rgb, alpha = fn(*args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(10):
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t))
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    rgb_c, alpha_c = fn_cpu({k: v.cpu() for k, v in args[0].items()},
                            *args_cpu[1:])
    err = max(float((rgb.cpu() - rgb_c).abs().max()),
              float((alpha.cpu() - alpha_c).abs().max()))
    out["graft_entry"] = dict(ms_median=float(np.median(runs)), ms_runs=runs,
                              max_abs_err_vs_cpu=err,
                              alpha_max=float(alpha.max()))
    print(f"[tiled] graft_entry.entry(): {float(np.median(runs)):.2f} ms a "
          f"call (median of 10, host clock), rgb {tuple(rgb.shape)}, "
          f"max|card - CPU| {err:.3g} (tol 1e-4); {card}", flush=True)
    if not err <= 1e-4 or not torch.isfinite(rgb).all():
        raise AssertionError(f"graft entry: card and CPU differ by {err}")
    report["tiled_phase"] = out
    return out


FWD_STAGES = ("carve", "unets", "select_head", "binning", "kernel", "untile",
              "loss")
# The main-path array sets, by the report key of the phase that makes them.
CELLS = dict(slice_phase="eval2d", train_phase="train2d",
             eval3d_phase="eval3d", train3d_phase="train3d")
BWD_STAGES = ("loss_bwd", "kernel_bwd", "backward")


def train_phase(report, key, config, k_steps, later):
    """train_from_config at ``config`` for ``k_steps`` steps, then steps
    timed whole, then the backward kernel against its plain version on a
    step's own arrays."""
    import torch

    from pose_splatter_torch.ops import carving
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.loop import make_train_step
    from pose_splatter_torch.train.trainer import train_from_config
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.synthetic import FrameSet
    from pose_splatter_torch.data.dataset import FrameLoader

    t0 = time.perf_counter()
    Ks, Es, frames = ring_scene(config, VIEWS, k_steps + K_EXTRA, seed=1)
    observed = [v for v in range(VIEWS) if v not in config.holdout_views]
    train = FrameSet(frames, observed, seed=2)
    valid = FrameSet({k: v[:2] for k, v in frames.items()}, observed,
                     split="valid")
    print(f"[{key}] train data: {k_steps + K_EXTRA} synthetic frames x {VIEWS} views "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    # What is still allocated (an earlier phase's model kept for its
    # deferred profile) is not this phase's.
    base_bytes = torch.cuda.memory_allocated()

    # ---- the main path, with the launch counts zeroed around it ----
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    carving.ray_cast_visibility_pair.launches = 0
    t0 = time.perf_counter()
    with stages.record() as rec:
        state, losses, _ = train_from_config(
            config, epochs=1, max_batches=k_steps, batch_size=1, seed=0,
            device="cuda", cameras=(Ks, Es), datasets=(train, valid),
            make_plots=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = dict(composite_fwd=K.composite_instances.launches,
                    composite_bwd=K.composite_instances_bwd.launches)
    carve_launches = carving.ray_cast_visibility_pair.launches
    # ---------------------------------------------------------------
    sp = rec.spans
    n = len(sp["optimizer"])
    steps = []
    for i in range(n):
        st = {k: sp[k][i] for k in ("data",) + FWD_STAGES + BWD_STAGES
              + ("optimizer",)}
        fwd = sum(st[k] for k in FWD_STAGES)
        bwd = sum(st[k] for k in BWD_STAGES)
        steps.append(dict(
            step=i, stages_ms=st, forward_ms=fwd, backward_ms=bwd,
            step_ms=fwd + bwd + st["optimizer"],
            loss=rec.values["loss"][i].item(),
            overflow=float(rec.values["optimizer"][i]["overflow"]),
            gaussians=int(rec.values["select_head"][i]["valid"].sum())))
        print(f"[{key}] train step {i}: loss {steps[-1]['loss']:.6f} | forward "
              f"{fwd:.2f} ms, backward {bwd:.2f} ms, optimizer "
              f"{st['optimizer']:.2f} ms | "
              + " ".join(f"{k} {v:.2f}" for k, v in st.items())
              + f" | gaussians {steps[-1]['gaussians']} overflow "
              f"{steps[-1]['overflow']:.0f}", flush=True)
    warm = steps[2:]  # cuDNN algorithm choice and the allocator settle
    med = {k: float(np.median([s[k] for s in warm]))
           for k in ("step_ms", "forward_ms", "backward_ms")}
    med_stages = {k: float(np.median([s["stages_ms"][k] for s in warm]))
                  for k in warm[0]["stages_ms"]}
    print(f"[{key}] main path: train_from_config {n} steps in {t_train:.2f} s; "
          f"recorded steps after warm-up (median of {len(warm)}): step "
          f"{med['step_ms']:.2f} ms = forward {med['forward_ms']:.2f} + "
          f"backward {med['backward_ms']:.2f} + optimizer | stage medians "
          + " ".join(f"{k} {v:.2f}" for k, v in med_stages.items())
          + f" ms; launches {launches}, carve_visibility {carve_launches} "
          f"(the steps' and the validation's frames)", flush=True)
    if n != k_steps or state.step != k_steps:
        raise AssertionError(f"{n} steps recorded, state at {state.step}")
    if min(launches.values()) < k_steps:
        raise AssertionError(f"a kernel was not launched every step: {launches}")
    if carve_launches < k_steps:
        raise AssertionError(f"{k_steps} steps made {carve_launches} "
                             "carve_visibility launches")
    if not all(np.isfinite(s["loss"]) for s in steps) or not np.isfinite(
            losses[-1]).all():
        raise AssertionError("non-finite training loss")
    bad = [k for k, p in state.model.net.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"non-finite gradients: {bad[:5]}")

    # ---- steps timed whole, launches read around each ----
    model = state.model
    step_fn = make_train_step(model, state.optimizer, config.img_lambda,
                              config.ssim_lambda)
    batches = iter(FrameLoader(train, batch_size=1, shuffle=False, prefetch=0))
    extra_batches = [next(batches) for _ in range(K_EXTRA)]
    extra = []
    for batch in extra_batches * EXTRA_PASSES:
        torch.cuda.synchronize()
        before = (K.composite_instances.launches,
                  K.composite_instances_bwd.launches,
                  carving.ray_cast_visibility_pair.launches)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        extra.append(dict(
            step_ms=ms, loss=float(m["total"]),
            fwd_launches=K.composite_instances.launches - before[0],
            bwd_launches=K.composite_instances_bwd.launches - before[1],
            carve_launches=carving.ray_cast_visibility_pair.launches - before[2]))
    whole_ms = float(np.median([e["step_ms"] for e in extra]))
    print(f"[{key}] unrecorded steps: " + "; ".join(
        f"{e['step_ms']:.2f} ms, loss {e['loss']:.6f}, composite_fwd "
        f"{e['fwd_launches']} / composite_bwd {e['bwd_launches']} / "
        f"carve_visibility {e['carve_launches']} launch(es)"
        for e in extra) + f"; median {whole_ms:.2f} ms", flush=True)
    if any(e["fwd_launches"] != 1 or e["bwd_launches"] != 1
           or e["carve_launches"] != 1 for e in extra):
        raise AssertionError("a train step did not launch each kernel once")
    busy = {}

    def step_busy():
        busy.update(device_busy(lambda: step_fn(state, extra_batches[0])))
        print(f"[{key}] one more step under torch.profiler: the card was "
              f"busy {busy['busy_ms']:.2f} ms of its {busy['wall_ms']:.2f} ms "
              f"({100 * busy['busy_share']:.1f} %), {busy['kernels']} device "
              f"operations", flush=True)

    later.append(step_busy)

    # ---- the backward kernel on the last recorded step's own arrays ----
    bargs = rec.values["kernel_bwd"][-1]
    inst, tbounds, astarts, counts, origins, jstop = bargs[:6]
    tile, G = bargs[8], bargs[9]
    d = K.composite_instances_bwd(*bargs)
    d_ref = K.composite_instances_bwd_ref(*bargs)
    torch.cuda.synchronize()
    rel, tol = bwd_error(d, d_ref, jstop, tile, G)
    ms = cuda_ms(lambda: K.composite_instances_bwd(*bargs), 20, 2)
    plain_ms = cuda_ms(lambda: K.composite_instances_bwd_ref(*bargs), 2)
    bound = bwd_bound(inst, astarts, counts, jstop, tile, G)
    hot = int(jstop.argmax())
    one = (inst, tbounds, astarts[hot:hot + 1].contiguous(),
           counts[hot:hot + 1].contiguous(), origins[hot:hot + 1].contiguous(),
           jstop[hot:hot + 1].contiguous(), bargs[6][hot:hot + 1].contiguous(),
           bargs[7][hot:hot + 1].contiguous()) + tuple(bargs[8:])
    hot_ms = cuda_ms(lambda: K.composite_instances_bwd(*one), 20, 2)
    fargs = (inst, astarts, counts, origins, tile, G, bargs[10])
    fwd_ms = cuda_ms(lambda: K.composite_instances(*fargs), 20, 2)
    fwd_store_ms = cuda_ms(
        lambda: K.composite_instances(*fargs, save_tbounds=True), 20, 2)
    fwd_plain_ms = cuda_ms(lambda: K.composite_instances_ref(*fargs), 2)
    # The forward too, against its plain version on the step's arrays.
    fg = K.composite_instances(*fargs, save_tbounds=True)
    fr = K.composite_instances_ref(*fargs, save_tbounds=True)
    fwd_err = max(float((x - y).abs().max()) for x, y in
                  ((fg[0], fr[0]), (fg[1], fr[1]), (fg[3], fr[3])))
    if not fwd_err <= TOL or not torch.equal(fg[2], fr[2]):
        raise AssertionError(f"[{key}] forward kernel disagrees on the step's "
                             f"arrays ({fwd_err}) or jstop does")
    fwd_bound = kernel_bound(astarts, counts, jstop, tile, G)
    split = split_stats(CELLS[key], "composite_bwd", inst.shape[0], counts,
                        jstop, tile, G, ms, bound["bound_ms"],
                        lambda: K.composite_instances_bwd(*bargs), later)
    fwd_split = split_stats(CELLS[key], "composite_fwd", inst.shape[0], counts,
                            jstop, tile, G, fwd_ms, fwd_bound["bound_ms"],
                            lambda: K.composite_instances(*fargs), later)
    main_kernel = dict(max_abs_err=float((d - d_ref).abs().max()), rel_err=rel,
                       rel_tol=tol, ms=ms, plain_ms=plain_ms,
                       longest_tile_alone_ms=hot_ms, fwd_ms=fwd_ms,
                       fwd_max_abs_err=fwd_err,
                       fwd_store_ms=fwd_store_ms, fwd_plain_ms=fwd_plain_ms,
                       fwd_bound=fwd_bound, split=split, fwd_split=fwd_split,
                       **bound)
    print(f"[{key}] main-path composite_bwd ({bargs[10]}): max|kernel-plain| "
          f"{main_kernel['max_abs_err']:.3g}, {rel:.3g} of each column's "
          f"largest (tol {tol:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['ops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.2f} MB); "
          f"{bound['busy_tiles']} of {counts.numel()} tiles hold instances, "
          f"the longest walk is {bound['max_tile_chunks']} chunks and takes "
          f"{hot_ms:.4f} ms alone | composite_fwd on the same instances "
          f"{fwd_ms:.4f} ms, with the store {fwd_store_ms:.4f} ms, plain "
          f"{fwd_plain_ms:.2f} ms, max|kernel-plain| {fwd_err:.3g}", flush=True)
    if not rel <= tol:
        raise AssertionError(f"main-path backward kernel disagrees ({rel})")
    if max(s["gaussians"] for s in steps) < N_GAUSS:
        raise AssertionError("selection never reached max_n")
    report[key] = dict(
        launches=launches, carve_launches=carve_launches,
        train_from_config_s=t_train, steps=steps,
        median_after_warmup=med, stage_medians_ms=med_stages,
        unrecorded_steps=extra, unrecorded_median_ms=whole_ms,
        step_device_busy=busy, epoch_losses=losses,
        main_path_kernel=main_kernel,
        peak_memory_gb=(torch.cuda.max_memory_allocated() - base_bytes) / 1e9)
    print(f"[{key}] train peak device memory "
          f"{report[key]['peak_memory_gb']:.2f} GB", flush=True)
    return launches, main_kernel, dict(state=state, frames=frames,
                                       observed=observed, cameras=(Ks, Es))


def multistep_phase(report, key, config, trained, later):
    """``make_train_multi_step`` on the train phase's state: a warm-up call
    (eager warm-up steps, the capture, replays), a copy of weights, statistics
    and Adam's state into a twin model, then MS_K graph-replayed steps
    against MS_K eager ``make_train_step`` steps of the twin on the same
    frames and views: every loss and the final parameters and statistics.
    Then ms a step both ways (host clock around synchronised calls, median
    of 3 calls) and, deferred, the card's busy share of one K-step call
    beside an eager step's."""
    import copy

    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.loop import (
        WARMUP_STEPS,
        TrainState,
        adam,
        make_train_multi_step,
        make_train_step,
    )
    from pose_splatter_torch.train.trainer import build_model

    state, frames = trained["state"], trained["frames"]
    observed = np.asarray(trained["observed"])
    model = state.model
    stack = dict(mask=frames["mask"][:, observed],
                 img=frames["img"][:, observed], p_3d=frames["p_3d"],
                 angle=frames["angle"])
    rng = np.random.default_rng(7)

    def draw():
        pos = rng.integers(len(observed), size=MS_K)
        return rng.integers(len(frames["angle"]), size=MS_K), observed[pos], pos

    ms = make_train_multi_step(model, state.optimizer, config.img_lambda,
                               config.ssim_lambda, stack, steps_per_call=MS_K)
    t0 = time.perf_counter()
    state, _ = ms(state, *draw())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    twin = build_model(config, cameras=trained["cameras"], device="cuda",
                       seed=0)
    twin.net.load_state_dict(model.net.state_dict())
    opt = adam(twin.net.parameters(), config.lr)
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    twin_state = TrainState(step=state.step, model=twin, optimizer=opt)
    step = make_train_step(twin, opt, config.img_lambda, config.ssim_lambda)
    idx = draw()

    def batch(k):
        f = idx[0][k]
        b = {n: v[f:f + 1] for n, v in stack.items()}
        b.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
        return b

    # ---- the main path, with the launch counts zeroed around it ----
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    replays = ms.replays
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, _ = ms(state, *idx)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    replays = ms.replays - replays
    # The replays' tensors, the kernels' scratch included, live in the
    # graph's pool: the call leaves only its [K, 5] metrics allocated.
    alloc_delta = torch.cuda.memory_allocated() - allocated
    through_wrappers = dict(composite_fwd=K.composite_instances.launches,
                            composite_bwd=K.composite_instances_bwd.launches)
    # ---------------------------------------------------------------
    launches = {k: replays * n for k, n in ms.graph_launches.items()}
    graph_losses = ms.step_metrics["total"].tolist()
    eager_losses = []
    for k in range(MS_K):
        twin_state, m = step(twin_state, batch(k))
        eager_losses.append(float(m["total"]))
    diffs, equal = {}, 0
    for (name, x), y in zip(model.net.state_dict().items(),
                            twin.net.state_dict().values()):
        diffs[name] = float((x - y).abs().max())
        equal += int(torch.equal(x, y))
    loss_diff = max(abs(a - b) for a, b in zip(graph_losses, eager_losses))
    param_diff = max(diffs.values())
    worst = max(diffs, key=diffs.get)
    bit_equal = loss_diff == 0 and equal == len(diffs)
    print(f"[{key}] multi-step: warm-up call {first_s:.2f} s ({WARMUP_STEPS} "
          f"eager steps, the capture, {MS_K - WARMUP_STEPS} replays); a call "
          f"of {MS_K} replays "
          f"{call_ms:.1f} ms; compositor launches {launches} ({replays} "
          f"replays x {ms.graph_launches} a captured step; through the "
          f"wrappers during the replays {through_wrappers}) | graph losses "
          + " ".join(f"{x:.6f}" for x in graph_losses) + " | eager losses "
          + " ".join(f"{x:.6f}" for x in eager_losses)
          + f" | max |loss diff| {loss_diff:.3g}, {equal} of {len(diffs)} "
          f"tensors bit-equal, max |param diff| {param_diff:.3g} ({worst})"
          f"; bit-equal: {bit_equal}; device memory left allocated by the "
          f"call {alloc_delta} bytes", flush=True)
    if replays != MS_K or min(launches.values()) < MS_K:
        raise AssertionError(f"[{key}] {replays} replays, launches {launches}")
    if any(through_wrappers.values()):
        raise AssertionError(f"[{key}] a replay went through a wrapper")
    if alloc_delta > 4096:
        raise AssertionError(f"[{key}] the replays allocated {alloc_delta} "
                             "bytes outside the graph's pool")
    if not np.isfinite(graph_losses).all():
        raise AssertionError(f"[{key}] non-finite multi-step loss")
    if not (loss_diff <= MS_LOSS_RTOL * max(map(abs, eager_losses))
            and param_diff <= 2 * config.lr * MS_K):
        raise AssertionError(f"[{key}] the graph-replayed steps disagree with "
                             f"the eager ones ({loss_diff}, {param_diff})")
    if bool(model.selection_miss) or bool(twin.selection_miss):
        raise AssertionError(f"[{key}] the selection flag is set")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    graph_runs = [timed(lambda: ms(state, *draw())) / MS_K for _ in range(3)]
    eager_runs = [timed(lambda: step(twin_state, batch(0))) for _ in range(3)]
    out = dict(
        steps_per_call=MS_K, warmup_call_s=first_s, call_ms=call_ms,
        launches=launches, graph_launches_per_step=ms.graph_launches,
        launches_through_wrappers=through_wrappers,
        allocated_by_call_bytes=alloc_delta, graph_losses=graph_losses,
        eager_losses=eager_losses, max_loss_diff=loss_diff,
        max_param_diff=param_diff, worst_param=worst,
        tensors_bit_equal=equal, tensors=len(diffs), bit_equal=bit_equal,
        graph_ms_per_step=graph_runs, eager_ms_per_step=eager_runs,
        graph_ms_median=float(np.median(graph_runs)),
        eager_ms_median=float(np.median(eager_runs)),
        selection_flag=False, busy={})
    print(f"[{key}] ms a step: K-step call {out['graph_ms_median']:.2f} "
          f"(calls of {MS_K}: "
          + ", ".join(f"{x:.2f}" for x in graph_runs)
          + f"), eager step {out['eager_ms_median']:.2f} ("
          + ", ".join(f"{x:.2f}" for x in eager_runs) + ")", flush=True)

    def busy():
        g = device_busy(lambda: ms(state, *draw()))
        e = device_busy(lambda: step(twin_state, batch(0)))
        out["busy"] = dict(graph_call=g, eager_step=e)
        print(f"[{key}] under torch.profiler: a {MS_K}-step call busy "
              f"{g['busy_ms']:.2f} of {g['wall_ms']:.2f} ms "
              f"({100 * g['busy_share']:.1f} %, {g['counted']}), an eager "
              f"step busy {e['busy_ms']:.2f} of {e['wall_ms']:.2f} ms "
              f"({100 * e['busy_share']:.1f} %, {e['counted']})", flush=True)
        if min(g["counted"].values()) < MS_K:
            raise AssertionError(f"[{key}] the profiler saw {g['counted']} "
                                 f"compositor kernels in {MS_K} replays")

    later.append(busy)
    report[key] = out
    return out


# The synthetic quality benchmark at SYNTH_BENCH.json's shape (its lr and
# crop offsets are not recorded there: the script's default lr and the crop
# of configs/templates/tpu_2d.json).
SYNTH_ARGS = ["--width", "576", "--height", "512", "--grid", "128",
              "--crop", "0,96,16,96,25,89", "--cameras", "6", "--mode", "2d",
              "--anchored", "--radii", "0.065,0.032,0.028", "--min-n", "1024",
              "--max-n", "16000", "--per-camera"]
SYNTH_STEPS = 64
SYNTH_STATE = ROOT / "build" / "synth_state.pt"


def synth_phase(report):
    """``python -m pose_splatter_torch.scripts.synthetic_benchmark`` at
    SYNTH_BENCH.json's shape for SYNTH_STEPS steps, 8 a call: its report,
    checked for the JAX script's keys and finite metrics. Its state goes to
    SYNTH_STATE (``--save-state``) for the temporal phase."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.scripts import synthetic_benchmark as sb

    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    SYNTH_STATE.parent.mkdir(parents=True, exist_ok=True)
    out = sb.main(SYNTH_ARGS + ["--steps", str(SYNTH_STEPS),
                                "--steps-per-call", "8",
                                "--save-state", str(SYNTH_STATE)])
    # The warm-up steps and the capture pass through the wrappers, the
    # replays do not; the evaluation's forwards do.
    launches = dict(composite_fwd=K.composite_instances.launches,
                    composite_bwd=K.composite_instances_bwd.launches)
    print(f"[synth] report: {json.dumps(out)}", flush=True)
    print(f"[synth] compositor launches through the wrappers {launches}",
          flush=True)
    keys = {"config", "steps", "train_time_s", "steps_per_s",
            "holdout_psnr_db", "holdout_ssim", "holdout_iou", "backend",
            "per_camera", "observed_psnr_db", "observed_ssim", "holdout_view",
            "hbm_peak_bytes", "hbm_limit_bytes"}
    if set(out) != keys:
        raise AssertionError(f"synthetic report keys {sorted(out)}")
    if out["backend"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"synthetic backend {out['backend']}")
    nums = [out["holdout_psnr_db"], out["holdout_ssim"], out["holdout_iou"],
            out["observed_psnr_db"]] + [
        x for row in out["per_camera"].values() for x in row.values()]
    if not np.isfinite(nums).all() or len(out["per_camera"]) != 6:
        raise AssertionError("non-finite or missing synthetic metrics")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the synthetic run launched {launches}")
    report["synth_phase"] = dict(out, launches_through_wrappers=launches)
    return out


# ----------------------------------------------------------------------------
# Serving a long recording and its input side: the temporal benchmark, the
# input-pipeline probe and the environment check-up.
# ----------------------------------------------------------------------------

def boundaries():
    """What this machine can pay of the end-to-end boundaries: the
    storage of the frames (``images.h5`` needs h5py), PNGs (PIL) and the
    MP4 mux (ffmpeg), and the words that name them."""
    import importlib.util
    import shutil

    h5 = importlib.util.find_spec("h5py") is not None
    png = importlib.util.find_spec("PIL") is not None
    mp4 = shutil.which("ffmpeg") is not None
    words = (("disk reads (FrameDataset/images.h5)" if h5 else
              "memory reads (FrameDataset over a uint8 array; h5py absent)")
             + (" + PNG writer pool" if png else " (PIL absent: no PNG)")
             + (" + mp4" if mp4 else " (ffmpeg absent: no mp4)"))
    return dict(h5=h5, png=png, mp4=mp4, mode=words)


def frame_dataset(root, images, poses, C, holdout, split):
    """The port's ``FrameDataset`` over uint8 frames ``images`` [T,C,H,W,3]
    and ``poses`` (centers, angles): read from ``images.h5`` under ``root``
    where h5py exists, else from the array in memory through a subclass
    that keeps every other method, the decode included."""
    from pose_splatter_torch.data.dataset import FrameDataset

    if boundaries()["h5"]:
        import h5py

        img_fn, cr_fn = str(root / "images.h5"), str(root / "poses.npz")
        with h5py.File(img_fn, "w") as f:
            d = f.create_dataset("images", images.shape, dtype="u1",
                                 chunks=(1, 1) + images.shape[2:])
            for t in range(len(images)):
                d[t] = images[t]
        np.savez(cr_fn, **poses)
        return FrameDataset(img_fn, cr_fn, C, holdout_views=[holdout],
                            split=split)

    class MemoryFrameDataset(FrameDataset):
        """``FrameDataset`` over an array in memory (no h5py here)."""

        def __init__(self):
            self.split, self.C = split, C
            self.observed_views = np.array(
                [i for i in range(C) if i != holdout], dtype=int)
            self._rng = np.random.default_rng(0)
            self.images = images
            T = len(images)
            self.i1, self.i2 = {"train": (0, T // 3), "all": (0, T)}[split]
            self.angles, self.centers = poses["angles"], poses["centers"]

    return MemoryFrameDataset()


def sequence_end_to_end(model, sc, frames, centers, angles, length, out_dir):
    """The temporal benchmark's ``--end-to-end`` loop (``run_sequence``)
    over ``length`` frames with what this machine has (``boundaries``):
    reads through ``FrameDataset`` and the native decode over SEQ_DISK_FRAMES
    rows (the unique poses repeated), PNGs into ``out_dir`` when PIL exists,
    the MP4 mux when ffmpeg does. Returns (seconds, the mux's seconds, the
    mode string, the PNGs written)."""
    import shutil

    from pose_splatter_torch.data import native
    from pose_splatter_torch.scripts import temporal_benchmark as tb

    if native.route() != "native":
        raise AssertionError("the native decode did not build")
    pay = boundaries()
    D, T = SEQ_DISK_FRAMES, len(frames)
    shutil.rmtree(out_dir, ignore_errors=True)
    (out_dir / "frames").mkdir(parents=True)
    reps = -(-D // T)
    images = np.ascontiguousarray(frames[np.arange(D) % T])
    poses = dict(centers=np.concatenate([centers] * reps)[:D],
                 angles=np.concatenate([angles] * reps)[:D],
                 covs=np.zeros((D, 3, 3), np.float32))
    ds = frame_dataset(out_dir, images, poses, sc["cameras"],
                       sc["cameras"] - 1, "all")
    write = tb.png_writer(str(out_dir / "frames")) if pay["png"] else None
    render_u8 = tb.make_render_u8(model, sc["cameras"] - 1)
    elapsed = tb.run_sequence(render_u8,
                              tb.dataset_reader(ds, D, model.device),
                              length, write)
    mux_s = tb.mux(str(out_dir / "frames"), str(out_dir / "sequence.mp4"))
    pngs = sorted((out_dir / "frames").glob("*.png"))
    return elapsed, mux_s, pay["mode"], pngs


def sequence_model():
    """The synth run's model (SYNTH_STATE) on the card, its scene's
    settings and its unique poses: (model, settings, frames, centers,
    angles)."""
    from pose_splatter_torch.scripts import synthetic_benchmark as sb
    from pose_splatter_torch.scripts import temporal_benchmark as tb

    model, sc = tb.load_state(str(SYNTH_STATE), "cuda")
    _, _, frames, centers, angles = sb.make_scene(
        sc["cameras"], sc["height"], sc["width"], T=sc["frames"],
        radii=tuple(sc["radii"]))
    return model, sc, frames, centers, angles


def input_dataset():
    """The input probe's INPUT_FRAMES frames as its train split, stored as
    ``boundaries`` allows, and the frames."""
    from pose_splatter_torch.scripts import dbg_input_pipeline as ip

    root = ROOT / "build" / "input"
    root.mkdir(parents=True, exist_ok=True)
    images = np.stack(list(ip.make_frames(INPUT_FRAMES)))
    ds = frame_dataset(root, images, ip.make_poses(INPUT_FRAMES), ip.C,
                       ip.C - 1, "train")
    return ds, images


def temporal_phase(report, later):
    """The temporal benchmark on the synth phase's state (SYNTH_STATE,
    SYNTH_BENCH.json's shape: 576x512, grid 128, crop 96x80x64, C = 6,
    view-anchored 2D). (a) ``python -m pose_splatter_torch.scripts.
    temporal_benchmark``'s default mode over SEQ_FRAMES frames (cut from
    3600 for the run's time) through its ``main``: the report with the JAX
    script's keys and ``decode``, the held-out PSNR within SEQ_PSNR_TOL dB
    of the synth phase's evaluation of the same state, the forward-kernel
    launches read around it equal to the frames rendered (the quality pass's
    unique poses and the sequence); then the forward kernel against its
    plain version on one sequence frame's binned arrays (TOL), its ms and
    bound. (b) The ``--end-to-end`` loop (``run_sequence``) over SEQ_FRAMES
    frames with what the machine has (``sequence_end_to_end``): one launch a
    frame, every PNG written, a PNG within one level of the default mode's
    uint8 render of its frame (the reads decode natively, one ulp from the
    staged payloads). (c) The card's busy share over SEQ_BUSY_FRAMES
    sequence frames (``device_busy``), appended to ``later``."""
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.scripts import temporal_benchmark as tb
    from pose_splatter_torch.utils import stages

    synth = report["synth_phase"]
    K.composite_instances.launches = 0
    rep = tb.main(["--state", str(SYNTH_STATE), "--length", str(SEQ_FRAMES)])
    launches = K.composite_instances.launches
    model, sc, frames, centers, angles = sequence_model()
    expected = sc["frames"] + SEQ_FRAMES
    print(f"[temporal] default mode, {SEQ_FRAMES} frames: {json.dumps(rep)}; "
          f"composite_fwd launches {launches} (expected {expected}: "
          f"{sc['frames']} quality-pass frames and the sequence)", flush=True)
    keys = set(tb.make_report(sc, "", 1, 1.0, None, dict(
        psnr=0, ssim=0, iou=0, lpips=None, lpips_gate=None), "cuda", ""))
    if set(rep) != keys or rep["backend"] != "cuda" or rep["decode"] != "numpy":
        raise AssertionError(f"[temporal] report {rep}")
    if abs(rep["holdout_psnr_db"] - synth["holdout_psnr_db"]) > SEQ_PSNR_TOL:
        raise AssertionError(
            f"[temporal] held-out PSNR {rep['holdout_psnr_db']} against the "
            f"synth phase's {synth['holdout_psnr_db']}")
    if launches != expected:
        raise AssertionError(f"[temporal] {launches} composite_fwd launches")

    read = tb.staged_reader(model, frames, centers, angles)
    render_u8 = tb.make_render_u8(model, sc["cameras"] - 1)
    with stages.record() as rec:
        ref_u8 = render_u8(*read(0)).cpu().numpy()
    b = rec.values["binning"][0]
    args = (b.inst, b.astarts, b.counts, b.origins, R.DEFAULT_TILE,
            R.DEFAULT_CHUNK, "ellipse")
    rgb_t, alpha_t, jstop = K.composite_instances(*args)
    ref = K.composite_instances_ref(*args)
    err = max(float((rgb_t - ref[0]).abs().max()),
              float((alpha_t - ref[1]).abs().max()))
    if not torch.equal(jstop, ref[2]):
        raise AssertionError("[temporal] jstop differs on a sequence frame")
    ms = cuda_ms(lambda: K.composite_instances(*args), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: K.composite_instances_ref(*args), iters=2)
    bound = kernel_bound(b.astarts, b.counts, jstop, R.DEFAULT_TILE,
                         R.DEFAULT_CHUNK)
    stage_ms = {n: round(v[0], 3) for n, v in rec.spans.items()}
    print(f"[temporal] one sequence frame's stages {stage_ms} ms | "
          f"composite_fwd (ellipse) on its arrays ({b.counts.numel()} tiles, "
          f"{bound['busy_tiles']} busy): max|kernel-plain| {err:.3g} (tol "
          f"{TOL}); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    if not err <= TOL:
        raise AssertionError(f"[temporal] the kernel disagrees ({err})")

    # ---- (b) the end-to-end loop ----
    K.composite_instances.launches = 0
    elapsed, mux_s, mode, pngs = sequence_end_to_end(
        model, sc, frames, centers, angles, SEQ_FRAMES,
        ROOT / "build" / "temporal")
    e2e_launches = K.composite_instances.launches
    q = dict(psnr=rep["holdout_psnr_db"], ssim=rep["holdout_ssim"],
             iou=rep["holdout_iou"], lpips=rep["lpips"],
             lpips_gate=rep["lpips_gate"])
    from pose_splatter_torch.data import native

    e2e = tb.make_report(sc, mode, SEQ_FRAMES, elapsed, mux_s, q, "cuda",
                         native.route())
    png_diff = None
    if boundaries()["png"]:
        from PIL import Image

        if len(pngs) != SEQ_FRAMES:
            raise AssertionError(f"[temporal] {len(pngs)} PNGs written")
        got = np.asarray(Image.open(pngs[0]))
        d = np.abs(got.astype(int) - ref_u8.astype(int))
        png_diff = dict(max=int(d.max()), share=float((d > 0).mean()))
        if got.shape != ref_u8.shape or d.max() > 1:
            raise AssertionError(f"[temporal] frame 0's PNG {png_diff}")
    print(f"[temporal] end to end, {SEQ_FRAMES} frames: {json.dumps(e2e)}; "
          f"composite_fwd launches {e2e_launches}; {len(pngs)} PNGs, frame "
          f"0's against the default mode's uint8 render: {png_diff}",
          flush=True)
    if e2e_launches != SEQ_FRAMES:
        raise AssertionError(f"[temporal] {e2e_launches} launches end to end")

    out = dict(default=rep, launches=launches, end_to_end=e2e,
               launches_e2e=e2e_launches, png_vs_render=png_diff,
               stages_ms=stage_ms, kernel=dict(max_abs_err=err, ms=ms,
                                               plain_ms=plain_ms, **bound))

    def busy():
        b = device_busy(lambda: tb.run_sequence(render_u8, read,
                                                SEQ_BUSY_FRAMES),
                        count=("fwd_sum",))
        out["device_busy"] = b
        print(f"[temporal] {SEQ_BUSY_FRAMES} sequence frames under the "
              f"profiler: {b['wall_ms']:.1f} ms wall, {b['busy_ms']:.1f} ms "
              f"on the card ({100 * b['busy_share']:.1f} % busy), "
              f"{b['kernels']} device operations, forward compositors "
              f"{b['counted']['fwd_sum']}", flush=True)

    later.append(busy)
    report["temporal_phase"] = out
    return out


def decode_ms(raw, reps: int = 5):
    """ms a frame of the native decode and of the NumPy one on ``raw``
    [C,H,W,3], alternating, best of ``reps``; and their largest difference
    (one ulp where they differ)."""
    from pose_splatter_torch.data import native

    times = dict(native=[], numpy=[])
    for _ in range(reps):
        for name, fn in (("native", native.decode_frame),
                         ("numpy", native.decode_frame_numpy)):
            t = time.perf_counter()
            fn(raw)
            times[name].append(1e3 * (time.perf_counter() - t))
    (m1, i1), (m2, i2) = native.decode_frame(raw), native.decode_frame_numpy(raw)
    if not np.array_equal(m1, m2):
        raise AssertionError("the native decode's mask differs from NumPy's")
    return dict(native_ms=min(times["native"]), numpy_ms=min(times["numpy"]),
                max_abs_diff=float(np.abs(i1 - i2).max()))


def input_phase(report):
    """``python -m pose_splatter_torch.scripts.dbg_input_pipeline`` at its
    own full width (INPUT_FRAMES frames of 6 views at 576x512, grid 128,
    INPUT_STEPS steps, INPUT_WORKERS loader threads) through its
    ``measure``, its frames stored as ``boundaries`` allows: the loader
    alone, the eager step alone and the two overlapped, both compositors'
    launches read around it; and a frame's decode, native against NumPy."""
    import torch

    from pose_splatter_torch.data import native
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.scripts import dbg_input_pipeline as ip

    if native.route() != "native":
        raise AssertionError("the native decode did not build")
    ds, images = input_dataset()
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    m = ip.measure(ds, INPUT_STEPS, INPUT_WORKERS, torch.device("cuda"))
    launches = dict(composite_fwd=K.composite_instances.launches,
                    composite_bwd=K.composite_instances_bwd.launches)
    rep = ip.make_report(m, INPUT_WORKERS, "cuda")
    dec = decode_ms(images[0])
    storage = ("images.h5" if boundaries()["h5"]
               else "a uint8 array in memory (h5py absent)")
    print(f"[input] {json.dumps(rep)}; frames from {storage}; compositor "
          f"launches {launches}; a frame's decode (6 x 512 x 576): native "
          f"{dec['native_ms']:.3f} ms, NumPy {dec['numpy_ms']:.3f} ms, "
          f"largest difference {dec['max_abs_diff']:.3g}", flush=True)
    if rep["decode"] != "native" or min(launches.values()) <= 0:
        raise AssertionError(f"[input] decode {rep['decode']}, launches "
                             f"{launches}")
    if not all(np.isfinite([m["data_ms"], m["step_ms"], m["overlapped_ms"]])):
        raise AssertionError(f"[input] {m}")
    out = dict(report=rep, storage=storage, launches=launches, decode=dec)
    report["input_phase"] = out
    return out


def doctor_phase(report):
    """``python -m pose_splatter_torch.scripts.doctor`` in a subprocess:
    exit 0, its lines printed."""
    proc = subprocess.run(
        [sys.executable, "-m", "pose_splatter_torch.scripts.doctor"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"[doctor] {line}", flush=True)
    report["doctor_phase"] = dict(rc=proc.returncode, out=proc.stdout)
    if proc.returncode != 0:
        raise AssertionError(f"doctor exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.returncode


RECORD_SYNTH_STEPS, RECORD_FRAMES, RECORD_BUSY_FRAMES = 3000, 3600, 64


def record_phase(report):
    """The numbers kept in the repository (``--record``), into
    ``chiprun_out/``: the synthetic benchmark at SYNTH_BENCH.json's shape
    for RECORD_SYNTH_STEPS steps, 8 a call, its state saved
    (``synth_record.json``); the temporal benchmark's default mode over
    RECORD_FRAMES frames through its ``main`` (``TEMPORAL_torch.json``);
    its end-to-end loop over RECORD_FRAMES frames with what the machine has
    (``sequence_end_to_end``; ``TEMPORAL_torch_e2e.json``); the card's busy
    share over RECORD_BUSY_FRAMES sequence frames; the input probe at its
    full width (``INPUT_PIPELINE_torch.json``) and a frame's decode, native
    against NumPy. Each file holds the card's name and power limit."""
    import torch

    from pose_splatter_torch.data import native
    from pose_splatter_torch.scripts import dbg_input_pipeline as ip
    from pose_splatter_torch.scripts import synthetic_benchmark as sb
    from pose_splatter_torch.scripts import temporal_benchmark as tb
    from pose_splatter_torch.scripts.common import write_report

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    SYNTH_STATE.parent.mkdir(parents=True, exist_ok=True)
    synth = sb.main(SYNTH_ARGS + [
        "--steps", str(RECORD_SYNTH_STEPS), "--steps-per-call", "8",
        "--save-state", str(SYNTH_STATE), "--out",
        str(out / "synth_record.json")])
    rep = tb.main(["--state", str(SYNTH_STATE), "--length",
                   str(RECORD_FRAMES), "--out",
                   str(out / "TEMPORAL_torch.json")])
    print(f"[record] synthetic held-out PSNR {synth['holdout_psnr_db']}, the "
          f"sequence's quality pass {rep['holdout_psnr_db']}", flush=True)
    model, sc, frames, centers, angles = sequence_model()
    elapsed, mux_s, mode, pngs = sequence_end_to_end(
        model, sc, frames, centers, angles, RECORD_FRAMES,
        ROOT / "build" / "temporal_record")
    q = dict(psnr=rep["holdout_psnr_db"], ssim=rep["holdout_ssim"],
             iou=rep["holdout_iou"], lpips=rep["lpips"],
             lpips_gate=rep["lpips_gate"])
    e2e = tb.make_report(sc, mode, RECORD_FRAMES, elapsed, mux_s, q, "cuda",
                         native.route())
    write_report(e2e, str(out / "TEMPORAL_torch_e2e.json"), "cuda")
    print(f"[record] end to end: {json.dumps(e2e)}; {len(pngs)} PNGs",
          flush=True)
    read = tb.staged_reader(model, frames, centers, angles)
    render_u8 = tb.make_render_u8(model, sc["cameras"] - 1)
    busy = device_busy(lambda: tb.run_sequence(render_u8, read,
                                               RECORD_BUSY_FRAMES),
                       count=("fwd_sum",))
    print(f"[record] {RECORD_BUSY_FRAMES} sequence frames under the "
          f"profiler: {json.dumps(busy)}", flush=True)
    del model
    ds, images = input_dataset()
    m = ip.measure(ds, INPUT_STEPS, INPUT_WORKERS, torch.device("cuda"))
    inp = ip.make_report(m, INPUT_WORKERS, "cuda")
    write_report(inp, str(out / "INPUT_PIPELINE_torch.json"), "cuda")
    dec = decode_ms(images[0])
    print(f"[record] input probe: {json.dumps(inp)}; a frame's decode "
          f"{json.dumps(dec)}", flush=True)
    report.update(synth=synth, temporal=rep, temporal_e2e=e2e,
                  device_busy=busy, input=inp, input_raw_ms=m, decode=dec)
    return report


# ----------------------------------------------------------------------------
# Phases of the carve's visibility cap, the adaptive camera, remat_unets and
# checkpoints across the two packages.
# ----------------------------------------------------------------------------

def visibility_row(vis, main, m2, m3):
    """The kernels line's row of ``csrc/carve_visibility.cu``: its launches
    on the main path (``main``: the train and eval phases' reports; a
    train step's and a served frame's, each held to one, and the
    K-step calls') and, at each carve shape (the ellipsoid's sets), ms a
    call host-launched and on the device, the plain version's, the bound
    of the function's own bytes and the one with the scratch table's
    fill; unsuffixed, those of the 2D north star's shape."""
    rows = {r["shape"]: r for r in vis["rows"] if r["sets"] == "ellipsoid"}
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_with_fill_ms",
            "occupied")
    t2, e2, t3, e3 = (main[k] for k in ("train_phase", "slice_phase",
                                        "train3d_phase", "eval3d_phase"))
    return dict(
        name="carve_visibility", route="cuda",
        source="pose_splatter_torch/csrc/carve_visibility.cu",
        replaces=None,
        launches=[e["carve_launches"] for e in t2["unrecorded_steps"]],
        launches_eval_path=e2["carve_launches_per_forward"],
        launches_3d_train=[e["carve_launches"]
                           for e in t3["unrecorded_steps"]],
        launches_3d_eval=e3["carve_launches_per_forward"],
        launches_train_from_config=t2["carve_launches"],
        launches_eval_entry_points=e2["carve_launches"],
        launches_multistep_2d=m2["launches"]["carve_visibility"],
        launches_multistep_3d=m3["launches"]["carve_visibility"],
        bit_equal=vis["bit_equal"], library_ms=None,
        **{k: rows["2d_576x512"][k] for k in keys},
        **{f"{k}_{shape}": r[k] for shape, r in rows.items() for k in keys})


def carve_cap_phase(report, later):
    """(a) ``carve_volume`` at the 2D north star's crop (96x80x64 = 491,520
    voxels) on the phase's synthetic frames: the occupied counts, then the
    carve timed exact, with a cap that fits (the largest
    second-threshold count rounded up to 1024) and with the production
    cap N/8 = 61,440, each with its overflow, by CUDA events around calls
    (the host launches them) and on the device (calls captured in a CUDA
    graph and replayed: the carve holds no read-back); the cap that fits within
    CAP_TOL of the exact carve with the occupancy and overflow exact; the
    visibility kernel's launches in two carves and the kernel at the main
    path's carve shapes against its plain version (``visibility_shapes``).
    Then one eval forward of 6 views with the fitting cap against the forward
    without it, and ``make_train_multi_step`` with the cap N/8 (8 steps a
    call, one captured step replayed) against 8 eager steps
    (``multistep_phase``)."""
    import torch

    from pose_splatter_torch.ops import carving
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.ops.carving import carve_volume
    from pose_splatter_torch.scripts import dbg_carve_micro as carve_micro
    from pose_splatter_torch.train.loop import create_train_state
    from pose_splatter_torch.train.trainer import build_model

    config = north_star_config(
        project_directory=str(ROOT / "build" / "carve_cap"))
    Ks, Es, frames = ring_scene(config, VIEWS, CAP_FRAMES)
    model = build_model(config, cameras=(Ks, Es), device="cuda", seed=0)
    obs = model.observed_views
    N = int(np.prod(model.input_size))
    assert N == 491_520
    cap_prod = N // 8

    # The frames on the card once: a carve then enqueues device work only
    # (no copy, no read-back), so a CUDA graph can hold it.
    inputs = [tuple(model._tensor(x) for x in (
        frames["mask"][f, obs], frames["img"][f, obs], frames["p_3d"][f],
        frames["angle"][f])) for f in range(CAP_FRAMES)]

    def carve(f, cap):
        return carve_volume(
            *inputs[f], model.grid, None, model.Ks_obs, model.viewmats_obs,
            volume_fill_color=model.volume_fill_color, visibility_cap=cap,
            return_overflow=True)

    counts = []
    for f in range(CAP_FRAMES):
        vol, _ = carve(f, None)
        counts.append(dict(occ1=int((vol[0] == 1).sum()),
                           occ2=int((vol[0] > 0).sum())))
    fit = -(-max(c["occ2"] for c in counts) // 1024) * 1024
    print(f"[carve_cap] {N} voxels; occupied (first / second threshold) "
          + ", ".join(f"frame {f}: {c['occ1']} / {c['occ2']}"
                      for f, c in enumerate(counts))
          + f"; caps: fits {fit}, N/8 {cap_prod}", flush=True)
    runs = {}
    exact = [carve(f, None)[0] for f in range(CAP_FRAMES)]
    for name, cap in (("exact", None), ("fits", fit), ("n_over_8", cap_prod)):
        ms = [cuda_ms(lambda f=f: carve(f, cap), CAP_ITERS, 2)
              for f in range(CAP_FRAMES)]
        dev_ms = [graph_ms(lambda f=f: carve(f, cap), CAP_ITERS, 3)
                  for f in range(CAP_FRAMES)]
        outs = [carve(f, cap) for f in range(CAP_FRAMES)]
        errs = [float((v - e).abs().max()) for (v, _), e in zip(outs, exact)]
        occ_equal = all(torch.equal(v[0], e[0]) for (v, _), e in zip(outs, exact))
        runs[name] = dict(cap=cap, ms=ms, ms_mean=float(np.mean(ms)),
                          device_ms=dev_ms,
                          device_ms_mean=float(np.mean(dev_ms)),
                          overflow=[int(o) for _, o in outs],
                          max_abs_diff_from_exact=max(errs),
                          occupancy_equal=occ_equal,
                          bit_equal=all(torch.equal(v, e) for (v, _), e
                                        in zip(outs, exact)))
        r = runs[name]
        print(f"[carve_cap] {name} (cap {cap}): a carve (frames "
              f"0-{CAP_FRAMES - 1}) host-launched "
              + ", ".join(f"{x:.4f}" for x in ms)
              + f" ms (CUDA events around {CAP_ITERS} calls), device "
              + ", ".join(f"{x:.4f}" for x in dev_ms)
              + f" ms ({CAP_ITERS} calls in a CUDA graph, 3 replays); "
              f"overflow {r['overflow']}; max|carve - exact| "
              f"{r['max_abs_diff_from_exact']:.3g}, occupancy equal "
              f"{occ_equal}, bit-equal {r['bit_equal']}", flush=True)
    # ---- the visibility kernel: a carve's launches, then the kernel at
    # the main path's three carve shapes against its plain version ----
    before = carving.ray_cast_visibility_pair.launches
    carve(0, None)
    carve(0, fit)
    torch.cuda.synchronize()
    vis_launches = carving.ray_cast_visibility_pair.launches - before
    vis_rows = carve_micro.visibility_shapes(
        "cuda", VIS_ITERS, device_timer=lambda fn: graph_ms(fn, VIS_ITERS, 3))
    vis = dict(launches_two_carves=vis_launches, rows=vis_rows,
               bit_equal=all(r["bit_equal"] for r in vis_rows))
    print(f"[carve_cap] carve_visibility launches in an exact and a capped "
          f"carve: {vis_launches}; the kernel bit-equal to its plain version "
          f"at every shape: {vis['bit_equal']}", flush=True)
    if vis_launches != 2 or not vis["bit_equal"]:
        raise AssertionError(f"[carve_cap] the visibility kernel: {vis}")

    f_run = runs["fits"]
    if any(f_run["overflow"]) or not f_run["occupancy_equal"] or not (
            f_run["max_abs_diff_from_exact"] <= CAP_TOL):
        raise AssertionError(f"[carve_cap] the fitting cap disagrees with "
                             f"the exact carve: {f_run}")
    if not runs["n_over_8"]["occupancy_equal"]:
        raise AssertionError("[carve_cap] the cap N/8 changed the occupancy")

    # ---- one eval forward with the fitting cap, against none ----
    fresh_start(model)
    view_idx = torch.arange(VIEWS, device="cuda")
    args = (frames["mask"][0, obs], frames["img"][0, obs], frames["p_3d"][0],
            frames["angle"][0], view_idx)
    model.carve_visibility_cap = None
    rgb0, alpha0 = model(*args)
    model.carve_visibility_cap = fit
    K.composite_instances.launches = 0
    rgb1, alpha1 = model(*args)
    torch.cuda.synchronize()
    eval_launches = K.composite_instances.launches
    fwd_diff = max(float((rgb1 - rgb0).abs().max()),
                   float((alpha1 - alpha0).abs().max()))
    fwd_equal = torch.equal(rgb1, rgb0) and torch.equal(alpha1, alpha0)
    print(f"[carve_cap] eval forward of {VIEWS} views with the cap {fit} "
          f"against none: max|diff| {fwd_diff:.3g} (tol {CAP_FWD_TOL}), "
          f"bit-equal {fwd_equal}; composite_fwd launches {eval_launches}",
          flush=True)
    if not fwd_diff <= CAP_FWD_TOL or eval_launches != 1:
        raise AssertionError("[carve_cap] the capped eval forward disagrees")

    # ---- K steps a call with the cap N/8, against eager steps ----
    del model
    cfg = north_star_config(carve_visibility_cap=cap_prod,
                            project_directory=str(ROOT / "build" / "carve_cap"))
    model = build_model(cfg, cameras=(Ks, Es), device="cuda", seed=0)
    fresh_start(model)
    trained = dict(state=create_train_state(model, cfg.lr), frames=frames,
                   observed=obs, cameras=(Ks, Es))
    ms = multistep_phase(report, "carve_cap_multistep", cfg, trained, [])
    report["carve_cap_phase"] = out = dict(
        voxels=N, occupied=counts, caps=dict(fits=fit, n_over_8=cap_prod),
        runs=runs, eval_max_abs_diff=fwd_diff, eval_bit_equal=fwd_equal,
        eval_launches=eval_launches, multistep_launches=ms["launches"],
        visibility=vis)
    return out


def adaptive3d_phase(report, card, later):
    """(b) ``configs/baseline/pigeon_4.json`` as written (4 ring cameras at
    656x320, grid 80, crop 80^3 = 512,000 voxels, 3D, adaptive camera, ell
    0.08, lr 1e-4, ssim_lambda 0, no holdout) on synthetic frames of an
    ellipsoid off the crop's centre: ``train_from_config`` for 6 steps
    (the loaders run the adaptive hook), 3 more steps timed whole,
    ``render_images_in_memory`` over 3 frames (each frame's ``temp_K`` and
    seed), the launches of both; then both compositors against their plain
    versions on the arrays one recorded adaptive train step binned
    (``bench_kernels``), and each frame's ``temp_K`` shift from K."""
    import torch

    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.evaluate import render_images_in_memory
    from pose_splatter_torch.train.loop import make_train_step
    from pose_splatter_torch.train.trainer import train_from_config
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.synthetic import FrameSet

    config = template_config(
        "configs/baseline/pigeon_4.json",
        project_directory=str(ROOT / "build" / "adaptive3d"))
    assert config.adaptive_camera and config.gaussian_mode == "3d"
    assert (config.render_width, config.render_height) == (656, 320)
    assert (config.lr, config.ssim_lambda) == (1e-4, 0.0)
    assert not config.holdout_views
    n_train = K_STEPS_3D + K_EXTRA
    Ks, Es, frames = ring_scene(config, CAMERAS_PIGEON, n_train, seed=1,
                                offset=PIGEON_OFFSET, axes=PIGEON_AXES)
    views = list(range(len(Ks)))
    train = FrameSet(frames, views, seed=2)
    valid = FrameSet({k: v[:2] for k, v in frames.items()}, views,
                     split="valid")

    # ---- the main path, with the launch counts zeroed around it ----
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    t0 = time.perf_counter()
    state, losses, _ = train_from_config(
        config, epochs=1, max_batches=K_STEPS_3D, batch_size=1, seed=0,
        device="cuda", cameras=(Ks, Es), datasets=(train, valid),
        make_plots=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    train_launches = dict(composite_fwd=K.composite_instances.launches,
                          composite_bwd=K.composite_instances_bwd.launches)
    model = state.model
    adaptive_fn = model.make_adaptive_fn()
    batches = list(FrameLoader(train, batch_size=1, shuffle=False, prefetch=0,
                               adaptive_fn=adaptive_fn))[K_STEPS_3D:]
    step_fn = make_train_step(model, state.optimizer, config.img_lambda,
                              config.ssim_lambda)
    step_ms, step_losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        step_losses.append(float(m["total"]))
    evalset = FrameSet({k: v[:3] for k, v in frames.items()}, views)
    render_images_in_memory(model, FrameSet(
        {k: v[:1] for k, v in frames.items()}, views))  # warm-up
    torch.cuda.synchronize()
    K.composite_instances.launches = 0
    t0 = time.perf_counter()
    rgba = render_images_in_memory(model, evalset)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    eval_launches = K.composite_instances.launches
    # ---------------------------------------------------------------
    shifts = []
    for f in range(3):
        temp_K, seed = adaptive_fn(frames["mask"][f])
        d = temp_K[:, :2, 2] - Ks[:, :2, 2]
        shifts.append(dict(shift_px=d.tolist(), seed=np.asarray(seed).tolist(),
                           p_3d=frames["p_3d"][f].tolist()))
    print(f"[adaptive3d] main path: train_from_config {K_STEPS_3D} steps in "
          f"{t_train:.2f} s (epoch losses {losses[-1]}), launches "
          f"{train_launches}; steps timed whole "
          + ", ".join(f"{x:.2f}" for x in step_ms)
          + " ms (losses " + ", ".join(f"{x:.6f}" for x in step_losses)
          + f"); render_images_in_memory 3 frames x {len(views)} views in "
          f"{1e3 * t_render:.1f} ms ({1e3 * t_render / 3:.2f} ms a frame), "
          f"composite_fwd launches {eval_launches}; {card}", flush=True)
    for f, s in enumerate(shifts):
        print(f"[adaptive3d] frame {f}: temp_K principal point - K (px) "
              + " ".join(f"({x:+.3f}, {y:+.3f})" for x, y in s["shift_px"])
              + f"; seed {np.round(s['seed'], 5).tolist()}", flush=True)
    if min(train_launches.values()) < K_STEPS_3D or eval_launches != 3:
        raise AssertionError(f"[adaptive3d] launches {train_launches}, "
                             f"{eval_launches}")
    if not np.isfinite(step_losses).all() or not np.isfinite(losses[-1]).all():
        raise AssertionError("[adaptive3d] non-finite loss")
    if rgba.shape != (3, len(views), config.render_height,
                      config.render_width, 4):
        raise AssertionError(f"[adaptive3d] rendered {rgba.shape}")
    if max(abs(x) for s in shifts for row in s["shift_px"] for x in row) <= 0:
        raise AssertionError("[adaptive3d] temp_K never left K")
    with stages.record() as rec:
        step_fn(state, batches[0])
    kernels = bench_kernels("adaptive3d", rec, None)
    report["adaptive3d_phase"] = out = dict(
        train_from_config_s=t_train, epoch_losses=losses,
        train_launches=train_launches, step_ms=step_ms,
        step_ms_median=float(np.median(step_ms)), step_losses=step_losses,
        render_ms=1e3 * t_render, ms_a_frame=1e3 * t_render / 3,
        eval_launches=eval_launches, temp_K=shifts, kernels=kernels,
        card=card)
    return out


def remat2d_phase(report, card, later):
    """(c) ``configs/templates/tpu_2d_highres.json`` as written (1152x1024,
    grid 256, crop 192x160x128 = 3,932,160 voxels, 6 cameras with holdout
    views [5, 1], 2D): twin models from the same fresh-start weights, one
    with ``remat_unets``. Each takes 2 eager train steps with cuDNN held to
    deterministic algorithms (losses and weights compared: within
    REMAT_RTOL of each tensor's largest, bit-equality reported), then 2
    steps with cuDNN's default choices, timed whole, with the peak device
    memory above the phase's start. Then both compositors against their
    plain versions on one recorded remat step's arrays (the backward's
    columns cancel there: ``bench_kernels(cancelling=True)``)."""
    import gc

    import torch

    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.loop import create_train_state, make_train_step
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.synthetic import FrameSet

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    config = template_config(
        "configs/templates/tpu_2d_highres.json",
        project_directory=str(ROOT / "build" / "remat2d"))
    assert (config.render_width, config.render_height) == (1152, 1024)
    assert config.grid_size == 256 and config.gaussian_mode == "2d"
    t0 = time.perf_counter()
    Ks, Es, frames = ring_scene(config, VIEWS, 4, seed=1)
    print(f"[remat2d] 4 synthetic frames x {VIEWS} views at 1152x1024 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    observed = [v for v in range(VIEWS) if v not in config.holdout_views]
    batches = list(FrameLoader(FrameSet(frames, observed, seed=2),
                               batch_size=1, shuffle=False, prefetch=0))
    weights0 = None
    runs = {}
    for remat in (False, True):
        cfg = template_config("configs/templates/tpu_2d_highres.json",
                              remat_unets=remat)
        model = build_model(cfg, cameras=(Ks, Es), device="cuda", seed=0)
        if weights0 is None:
            fresh_start(model)
            weights0 = {k: v.cpu() for k, v in model.net.state_dict().items()}
        else:
            model.net.load_state_dict(weights0)
        assert model.net.remat is remat
        state = create_train_state(model, cfg.lr)
        step = make_train_step(model, state.optimizer, cfg.img_lambda,
                               cfg.ssim_lambda)
        K.composite_instances.launches = 0
        K.composite_instances_bwd.launches = 0
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            losses = []
            for b in batches[:2]:
                state, m = step(state, b)
                losses.append(float(m["total"]))
        finally:
            torch.backends.cudnn.deterministic = saved
        after2 = {k: v.detach().cpu().clone()
                  for k, v in model.net.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for b in batches[2:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = dict(composite_fwd=K.composite_instances.launches,
                        composite_bwd=K.composite_instances_bwd.launches)
        runs[remat] = dict(losses=losses, weights=after2, step_ms=ms,
                           peak_gb=peak, launches=launches)
        print(f"[remat2d] remat_unets={remat}: deterministic steps' losses "
              + ", ".join(f"{x:.8f}" for x in losses) + "; steps timed whole "
              + ", ".join(f"{x:.1f}" for x in ms) + f" ms; peak {peak:.3f} GB "
              f"above the phase's start; launches {launches}; {card}",
              flush=True)
        if min(launches.values()) != 4:
            raise AssertionError(f"[remat2d] launches {launches}")
        if remat:
            with stages.record() as rec:
                step(state, batches[0])
            kernels = bench_kernels("remat2d", rec, None, cancelling=True)
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
    w_rel, equal = 0.0, 0
    for k, x in a["weights"].items():
        y = b["weights"][k]
        scale = float(x.abs().max()) or 1.0
        w_rel = max(w_rel, float((x - y).abs().max()) / scale)
        equal += int(torch.equal(x, y))
    bit_equal = a["losses"] == b["losses"] and equal == len(a["weights"])
    print(f"[remat2d] after 2 steps: losses within {loss_rel:.3g} relative, "
          f"weights within {w_rel:.3g} of each tensor's largest "
          f"(tol {REMAT_RTOL}); {equal} of {len(a['weights'])} tensors "
          f"bit-equal; bit-equal: {bit_equal}", flush=True)
    if not (loss_rel <= REMAT_RTOL and w_rel <= REMAT_RTOL):
        raise AssertionError("[remat2d] remat and no remat disagree")
    for r in runs.values():
        del r["weights"]
    report["remat2d_phase"] = out = dict(
        voxels=192 * 160 * 128,
        runs={("remat" if k else "plain"): v for k, v in runs.items()},
        loss_rel=loss_rel, weight_rel=w_rel, tensors_bit_equal=equal,
        bit_equal=bit_equal, kernels=kernels, card=card)
    return out


def bridge_phase(report, trained):
    """(d) The 2D train phase's state (its model and capturable Adam, as
    every later phase left them) through the inverse bridge and the Adam
    converter to the JAX payload tree and back: bit-equal, and the tree
    again equal. Then a twin loads the converted checkpoint file and takes
    one step beside the original, cuDNN held to deterministic algorithms:
    the losses and every weight and Adam tensor equal bit for bit."""
    import torch

    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.train import checkpoint_convert as cc
    from pose_splatter_torch.train.loop import (
        checkpoint_payload,
        create_train_state,
        load_checkpoint,
        make_train_step,
    )
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils.synthetic import FrameSet

    state, frames = trained["state"], trained["frames"]
    cfg = north_star_config()
    payload = checkpoint_payload(state)
    t0 = time.perf_counter()
    tree = cc.to_jax_tree(payload)
    back = cc.from_jax_tree(tree, state)
    convert_s = time.perf_counter() - t0

    def opt_equal(x, y):
        if sorted(x["state"]) != sorted(y["state"]):
            return False
        return all(torch.equal(x["state"][i][k].cpu(), y["state"][i][k].cpu())
                   for i in x["state"] for k in ("step", "exp_avg",
                                                 "exp_avg_sq"))

    n_leaves = sum(1 for _ in _leaves(tree["params"]))
    same = (all(torch.equal(payload["params"][k], back["params"][k])
                for k in payload["params"])
            and all(torch.equal(payload["batch_stats"][k], back["batch_stats"][k])
                    for k in payload["batch_stats"])
            and opt_equal(payload["opt_state"], back["opt_state"])
            and back["step"] == payload["step"])
    again = cc.to_jax_tree(back)
    tree_same = all(np.array_equal(x, y) for x, y in
                    zip(_leaves(tree), _leaves(again)))
    with_state = len(payload["opt_state"]["state"])
    print(f"[bridge] the train phase's state -> JAX tree ({n_leaves} "
          f"parameter leaves, Adam count {int(tree['opt_state'][0].count)}, "
          f"{with_state} of {len(payload['params'])} parameters with torch "
          f"state) -> port payload in {convert_s:.2f} s: bit-equal {same}; "
          f"tree again equal {tree_same}", flush=True)
    if not (same and tree_same):
        raise AssertionError("[bridge] the round trip is not bit-equal")

    path = str(ROOT / "build" / "bridge" / "converted.ckpt")
    twin = build_model(cfg, cameras=trained["cameras"], device="cuda", seed=3)
    twin_state = create_train_state(twin, cfg.lr)
    cc.save_jax_tree(path, tree, twin_state, extra={"epoch": 1})
    twin_state, extra = load_checkpoint(path, twin_state)
    batch = next(iter(FrameLoader(FrameSet(frames, trained["observed"], seed=5),
                                  batch_size=1, shuffle=False, prefetch=0)))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = []
        for s in (state, twin_state):
            fn = make_train_step(s.model, s.optimizer, cfg.img_lambda,
                                 cfg.ssim_lambda)
            s, m = fn(s, batch)
            steps.append((s, float(m["total"])))
    finally:
        torch.backends.cudnn.deterministic = saved
    (s0, l0), (s1, l1) = steps
    p0, p1 = checkpoint_payload(s0), checkpoint_payload(s1)
    w_equal = all(torch.equal(p0["params"][k], p1["params"][k])
                  for k in p0["params"]) and all(
        torch.equal(p0["batch_stats"][k], p1["batch_stats"][k])
        for k in p0["batch_stats"])
    a_equal = opt_equal(p0["opt_state"], p1["opt_state"])
    print(f"[bridge] one step from the original and from the converted "
          f"checkpoint: losses {l0:.8f} / {l1:.8f}, weights equal {w_equal}, "
          f"Adam state equal {a_equal}, extra {extra}", flush=True)
    if not (l0 == l1 and w_equal and a_equal and extra == {"epoch": 1}):
        raise AssertionError("[bridge] the resumed step differs")
    report["bridge_phase"] = out = dict(
        round_trip_bit_equal=same, tree_equal=tree_same,
        params_with_torch_state=with_state, adam_count=int(
            tree["opt_state"][0].count), convert_s=convert_s,
        resumed_losses=[l0, l1], resumed_bit_equal=True)
    return out


def preprocess_phase(report, trained):
    """Preprocessing and the visual-pose features at ``tpu_3d.json``'s full
    width.

    (a) ``calculate_visual_features`` with the 3D train phase's weights
    over 6 of its frames at L = 3 (32 views of 224², one forward-kernel
    launch a frame), writing ``feature_fn`` under ``build/``: ms a frame by
    the host clock (after a warm-up ``dry_run``), the launches read around
    it, the peak memory above the phase's start; then the same frames
    through ``make_frame_features`` with the stages recorded (the code's
    own marks) and each frame's rig overflow; the forward kernel against
    its plain version on the rig's own binned arrays (within TOL), with its
    time and bound; ResNet18 on one frame's 32 renders on the card against
    the same module on the CPU (within PRE_FEAT_REL of the largest).
    (b) ``_carve_moments_batch`` and ``_occupancy_batch`` on batches of
    PRE_BATCH frames at grid 112 (the full grid, 1,404,928 voxels), 4
    observed views at 288x256: device ms a batch (a CUDA graph where it
    captures, else CUDA events; the line says which), and the CPU's run of
    the same batch: occupancy and summed counts exact, means and
    covariances at rtol PRE_RTOL. (c) LPIPS with random ``.npz`` weights
    on 6 image pairs at 288x256, card against CPU at rtol PRE_RTOL_LPIPS.
    """
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.ops.carving import get_volume
    from pose_splatter_torch.ops.lpips import _ALEX_CFG, create_lpips
    from pose_splatter_torch.models.resnet import (
        create_feature_extractor,
        preprocess_imagenet,
    )
    from pose_splatter_torch.preprocess.center_rotation import _carve_moments_batch
    from pose_splatter_torch.preprocess.crop_indices import _occupancy_batch
    from pose_splatter_torch.preprocess.visual_features import (
        calculate_visual_features,
        make_frame_features,
    )
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import FrameSet

    out_dir = ROOT / "build" / "preprocess"
    out_dir.mkdir(parents=True, exist_ok=True)
    config = config_3d(project_directory=str(out_dir),
                       feature_fn="features.npy")
    model = trained["state"].model
    frames = {k: v[:PRE_FRAMES] for k, v in trained["frames"].items()}
    data = FrameSet(frames, trained["observed"])
    out = {}

    # ---- (a) the features pass, with the launch count zeroed around it ----
    torch.cuda.synchronize()
    calculate_visual_features(config, model, data, dry_run=True, progress=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.composite_instances.launches = 0
    t0 = time.perf_counter()
    feats = calculate_visual_features(config, model, data, L=PRE_L,
                                      progress=False)
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    launches = K.composite_instances.launches
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    written = np.load(config.feature_fn)
    n_views = 2 * (PRE_L + 1) ** 2
    print(f"[preprocess] calculate_visual_features: {PRE_FRAMES} frames x "
          f"{n_views} views of 224x224 in {total_ms:.1f} ms "
          f"({total_ms / PRE_FRAMES:.2f} ms a frame, host clock, set-up "
          f"included); composite_fwd launches {launches}; peak "
          f"{peak_gb:.3f} GB above the phase's start; features "
          f"{written.shape} {written.dtype}", flush=True)
    if launches != PRE_FRAMES:
        raise AssertionError(f"[preprocess] {launches} composite_fwd launches "
                             f"for {PRE_FRAMES} frames")
    if written.shape != (PRE_FRAMES, (PRE_L + 1) ** 2, 512) or not (
            written.dtype == np.float16 and np.isfinite(written).all()
            and np.array_equal(written, feats)):
        raise AssertionError("[preprocess] the written features are wrong")

    # The same frames and yaws, each timed whole, then with the stages
    # recorded.
    frame_features = make_frame_features(model, PRE_L)
    rng = np.random.default_rng(0)
    thetas = [2 * np.pi * rng.random() for _ in range(PRE_FRAMES)]
    inputs = [data.get(i, view_idx=0)[:4] for i in range(PRE_FRAMES)]
    frame_ms = []
    for i, (mask, img, p_3d, angle) in enumerate(inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame_features(mask, img, p_3d, np.float32(angle), np.float32(thetas[i]))
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"[preprocess] a frame timed whole (host clock, synchronised): "
          f"{', '.join(f'{x:.2f}' for x in frame_ms)} ms, median "
          f"{np.median(frame_ms):.2f}", flush=True)
    recorded = []
    with stages.record() as rec:
        for i, (mask, img, p_3d, angle) in enumerate(inputs):
            recorded.append(frame_features(mask, img, p_3d, np.float32(angle),
                                           np.float32(thetas[i])))
    rec_err = max(float(np.abs(f.cpu().numpy().astype(np.float16).astype(
        np.float32) - feats[i].astype(np.float32)).max())
        for i, f in enumerate(recorded))
    names = ("carve", "unets", "select_head", "binning", "kernel", "untile",
             "resnet", "sh")
    med = {n: float(np.median(rec.spans[n][1:])) for n in names}
    overflow = [int(b.overflow) for b in rec.values["binning"]]
    b = rec.values["binning"][0]
    instances = [int(x.counts.long().sum()) for x in rec.values["binning"]]
    print(f"[preprocess] stages a frame (median of frames 1-{PRE_FRAMES - 1}, "
          f"each mark synchronising): "
          + " ".join(f"{'composite_fwd' if n == 'kernel' else n} {v:.2f}"
                     for n, v in med.items())
          + f" ms | rig instances {instances}, overflow {overflow} (the "
          f"reference's per-camera cap 4N + T*G) | recorded features vs the "
          f"written ones after the float16 cast: {rec_err:.3g}", flush=True)

    args = (b.inst, b.astarts, b.counts, b.origins, R.DEFAULT_TILE,
            R.DEFAULT_CHUNK, "conic")
    rgb_t, alpha_t, jstop = K.composite_instances(*args)
    ref = K.composite_instances_ref(*args)
    err = max(float((rgb_t - ref[0]).abs().max()),
              float((alpha_t - ref[1]).abs().max()))
    if not torch.equal(jstop, ref[2]):
        raise AssertionError("[preprocess] jstop differs on the rig's arrays")
    ms = cuda_ms(lambda: K.composite_instances(*args), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: K.composite_instances_ref(*args), iters=2)
    bound = kernel_bound(b.astarts, b.counts, jstop, R.DEFAULT_TILE,
                         R.DEFAULT_CHUNK)
    print(f"[preprocess] composite_fwd (conic) on the rig's arrays "
          f"({b.counts.numel()} tiles, {bound['busy_tiles']} busy, "
          f"{bound['walked_rows']} rows walked): max|kernel-plain| {err:.3g} "
          f"(tol {TOL}); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    if not err <= TOL:
        raise AssertionError(f"[preprocess] the rig's kernel disagrees ({err})")

    renders = rec.values["resnet"][0]  # frame 0's [32, 224, 224, 3]
    extract, net = create_feature_extractor(None, "cuda")
    cpu_net = type(net)()
    cpu_net.load_state_dict(net.state_dict())
    with torch.no_grad():
        f_card = extract(renders)
        f_cpu = cpu_net.eval()(preprocess_imagenet(renders.cpu()))
    resnet_ms = cuda_ms(lambda: extract(renders), iters=10, warmup=2)
    resnet_err = float((f_card.cpu() - f_cpu).abs().max())
    resnet_scale = float(f_cpu.abs().max())
    print(f"[preprocess] ResNet18 on frame 0's {renders.shape[0]} renders: "
          f"card vs CPU {resnet_err:.3g} ({resnet_err / resnet_scale:.3g} of "
          f"the largest, bound {PRE_FEAT_REL}); {resnet_ms:.3f} ms a call on "
          f"the card (CUDA events)", flush=True)
    if not resnet_err <= PRE_FEAT_REL * resnet_scale:
        raise AssertionError("[preprocess] ResNet18 on the card disagrees")
    out.update(frames=PRE_FRAMES, views=n_views, total_ms=total_ms,
               ms_a_frame=float(np.median(frame_ms)), frame_ms=frame_ms,
               launches=launches,
               peak_memory_gb=peak_gb, stage_medians_ms=med,
               overflow=overflow, instances=instances,
               kernel=dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound),
               resnet=dict(max_abs_err=resnet_err, scale=resnet_scale,
                           ms=resnet_ms))
    del rec, recorded, renders

    # ---- (b) the two preprocessing carves, card against CPU ----
    Ks, Es, fr = ring_scene(config, VIEWS, PRE_BATCH, seed=4)
    obs = trained["observed"]
    cam = (torch.as_tensor(Ks[obs]), torch.as_tensor(Es[obs]))
    masks = torch.as_tensor(fr["mask"][:, obs])
    # World centre of each frame's ellipsoid (the crop's centre, yawed, plus
    # the frame's shift): where the rough-centre step would put it.
    crop_c = create_3d_grid(config.ell, config.grid_size,
                            config.volume_idx).reshape(-1, 3).mean(0)
    ang = fr["angle"].astype(np.float64)
    centers = np.stack([np.cos(ang) * crop_c[0] - np.sin(ang) * crop_c[1],
                        np.sin(ang) * crop_c[0] + np.cos(ang) * crop_c[1],
                        np.full_like(ang, crop_c[2])], 1) + fr["p_3d"]
    centers = torch.as_tensor(centers, dtype=torch.float32)
    angles = torch.as_tensor(fr["angle"])
    grid_t = torch.as_tensor(create_3d_grid(config.ell_tracking,
                                            config.grid_size))
    grid_c = torch.as_tensor(create_3d_grid(config.ell, config.grid_size))
    C = len(obs)
    thr = (C - 1.0) / C
    runs = {}
    for d in ("cuda", "cpu"):
        t = lambda x: x.to(d)  # noqa: E731
        mk = (t(masks), t(centers), t(grid_t), t(cam[0]), t(cam[1]))
        oc = (t(masks), t(centers), t(angles), t(grid_c), t(cam[0]), t(cam[1]))
        t0 = time.perf_counter()
        means, covs = _carve_moments_batch(*mk, carve_threshold=thr)
        binary = get_volume(mk[0][..., None], mk[3], mk[4],
                            mk[2][None] + mk[1][:, None, None, None, :]
                            )[:, 0] >= thr
        occ = _occupancy_batch(*oc, carve_threshold=thr)
        if d == "cuda":
            torch.cuda.synchronize()
        runs[d] = dict(means=means.cpu(), covs=covs.cpu(), binary=binary.cpu(),
                       occ=occ.cpu(), s=time.perf_counter() - t0)
        if d == "cuda":
            timing = {}
            for name, fn in (
                    ("carve_moments", lambda: _carve_moments_batch(
                        *mk, carve_threshold=thr)),
                    ("occupancy", lambda: _occupancy_batch(
                        *oc, carve_threshold=thr))):
                # 4 calls a graph: a call holds gigabytes of temporaries.
                g_ms, why = try_graph_ms(fn, launches=4, replays=3)
                timing[name] = dict(
                    ms=g_ms if g_ms is not None else cuda_ms(fn, iters=5),
                    how="CUDA graph" if g_ms is not None else
                    f"CUDA events ({why})")
            del mk, oc
            torch.cuda.empty_cache()
    gpu, cpu = runs["cuda"], runs["cpu"]
    occ_equal = torch.equal(gpu["binary"], cpu["binary"])
    sum_equal = torch.equal(gpu["occ"], cpu["occ"])
    grid_scale = float(grid_t.abs().max())
    mean_err = float((gpu["means"] - cpu["means"]).abs().max())
    cov_err = float(((gpu["covs"] - cpu["covs"]).abs()
                     / (cpu["covs"].abs() + cpu["covs"].abs().max())).max())
    moments_ok = (torch.allclose(gpu["means"], cpu["means"], rtol=PRE_RTOL,
                                 atol=PRE_RTOL * grid_scale)
                  and torch.allclose(gpu["covs"], cpu["covs"], rtol=PRE_RTOL,
                                     atol=PRE_RTOL * float(cpu["covs"].abs().max())))
    per_frame = gpu["binary"].reshape(PRE_BATCH, -1).sum(1).tolist()
    print(f"[preprocess] carves of {PRE_BATCH} frames x {C} views at "
          f"{W3}x{H3}, grid {config.grid_size} ({config.grid_size ** 3} "
          f"voxels): _carve_moments_batch "
          f"{timing['carve_moments']['ms']:.3f} ms a batch "
          f"({timing['carve_moments']['how']}), _occupancy_batch "
          f"{timing['occupancy']['ms']:.3f} ms a batch "
          f"({timing['occupancy']['how']}); CPU {cpu['s']:.2f} s for both; "
          f"occupied voxels a frame {per_frame}; occupancy equal {occ_equal}, "
          f"summed counts equal {sum_equal} (max {int(gpu['occ'].max())}); "
          f"means {mean_err:.3g}, covariances {cov_err:.3g} (rtol "
          f"{PRE_RTOL})", flush=True)
    if not (occ_equal and sum_equal and moments_ok and min(per_frame) > 0):
        raise AssertionError("[preprocess] the carves on the card disagree "
                             "with the CPU")
    out["carves"] = dict(batch=PRE_BATCH, views=C, grid=config.grid_size,
                         timing=timing, cpu_s=cpu["s"],
                         occupied_per_frame=per_frame, mean_err=mean_err,
                         cov_rel_err=cov_err)

    # ---- (c) LPIPS, card against CPU ----
    path = str(out_dir / "lpips_random.npz")
    rng = np.random.default_rng(7)
    w, cin = {}, 3
    for i, (f, k, _, _) in enumerate(_ALEX_CFG):
        w[f"conv{i}_kernel"] = rng.normal(0, (cin * k * k) ** -0.5,
                                          (k, k, cin, f)).astype(np.float32)
        w[f"conv{i}_bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        w[f"lin{i}"] = rng.uniform(0, 1, f).astype(np.float32)
        cin = f
    np.savez(path, **w)
    x = torch.as_tensor(fr["img"][0])  # 6 views at 288x256
    y = torch.as_tensor(fr["img"][1])
    lp_card = create_lpips(path, "cuda")
    d_card = lp_card(x.cuda(), y.cuda()).cpu()
    d_cpu = create_lpips(path, "cpu")(x, y)
    lp_ms = cuda_ms(lambda: lp_card(x.cuda(), y.cuda()), iters=10, warmup=2)
    lp_err = float(((d_card - d_cpu).abs() / d_cpu.abs()).max())
    print(f"[preprocess] LPIPS on {len(x)} pairs at {W3}x{H3}: card "
          f"{[round(float(v), 6) for v in d_card]}, CPU relative error "
          f"{lp_err:.3g} (rtol {PRE_RTOL_LPIPS}); {lp_ms:.3f} ms a call on the "
          f"card", flush=True)
    if not (lp_err <= PRE_RTOL_LPIPS and bool((d_cpu > 0).all())):
        raise AssertionError("[preprocess] LPIPS on the card disagrees")
    out["lpips"] = dict(pairs=len(x), rel_err=lp_err, ms=lp_ms,
                        card=d_card.tolist())
    report["preprocess_phase"] = out
    return out


def viz_eval_phase(report, trained3, trained2):
    """Novel views, evaluation, export and profiling at full width.

    (a) ``render_turntable`` with NOVEL_VIEWS offsets of one ring frame of
    the 3D train phase (``tpu_3d.json`` as written, its weights) at the
    image size 1152x1024 through the ring cameras' intrinsics scaled to
    ``ds = 1`` (x ``image_downsample``): the forward-kernel launches read
    around it (one a view), every view finite and showing the animal; ms a
    view (each view synchronised, median of NOVEL_VIEWS after a warm-up);
    one view with its stages recorded (the code's own marks); the forward
    kernel against its plain version on that view's binned arrays (rgb,
    alpha, ``jstop``, ``tbounds``; within TOL), its CUDA-event ms, bound
    and the plain version's ms; the instance rows kept and dropped at the
    reference's per-camera cap. (b) ``render_images_in_memory`` over the
    phase's 9 frames, then ``image_metrics`` and ``lpips_metric`` (seeded
    AlexNet weights written under ``build/``) over the test split on the
    card and on the CPU with the same uint8 arrays: each per-camera value
    within EVAL_RTOL relative. (c) ``extract_world_gaussians`` on the card
    and on a CPU twin of the model: counts equal, rows matched by their
    voxel, parameters within EXPORT_TOL of each array's largest; the four
    savers under ``build/``, the npz read back. (d) ``profile_model`` on the
    2D north star with the 2D train phase's weights, both compositors'
    launches read around it (its ``full_fwd_bwd`` is the only backward:
    one ``composite_bwd`` a call; ``composite_fwd`` in the render, the
    forward and the forward-and-backward), and ``trace`` over one
    ``fwd_bwd`` writing a non-empty ``torch.profiler`` trace.
    """
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.ops.lpips import _ALEX_CFG, create_lpips
    from pose_splatter_torch.train.evaluate import (
        image_metrics,
        lpips_metric,
        render_images_in_memory,
    )
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.profiling import fwd_bwd, profile_model, trace
    from pose_splatter_torch.utils.synthetic import FrameSet
    from pose_splatter_torch.viz.export import (
        EXTENSIONS,
        SAVERS,
        extract_world_gaussians,
    )
    from pose_splatter_torch.viz.render_image import (
        render_novel_view,
        render_turntable,
    )

    out_dir = ROOT / "build" / "viz_eval"
    out_dir.mkdir(parents=True, exist_ok=True)
    config = config_3d()
    model = trained3["state"].model
    frames, observed = trained3["frames"], trained3["observed"]
    data = FrameSet(frames, observed)
    Ks, Es = trained3["cameras"]
    ds = config.image_downsample
    Wf, Hf = config.image_width, config.image_height
    assert (Wf, Hf) == (W3 * ds, H3 * ds)
    K_full = np.array(Ks, np.float32)
    K_full[:, :2] *= ds  # fx, cx and fy, cy at ds = 1
    out = {}

    # ---- (a) novel views at the full image size ----
    view = 0
    inputs = data.get(0, view_idx=view)[:4]
    render_novel_view(model, *inputs, view, K_full, Wf, Hf)  # warm-up
    torch.cuda.synchronize()
    K.composite_instances.launches = 0
    t0 = time.perf_counter()
    views = render_turntable(model, *inputs, view, K_full, Wf, Hf,
                             n_steps=NOVEL_VIEWS)
    turntable_ms = 1e3 * (time.perf_counter() - t0)
    launches_nv = K.composite_instances.launches
    view_ms = []
    for k in range(NOVEL_VIEWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_novel_view(model, *inputs, view, K_full, Wf, Hf,
                          angle_offset=2 * np.pi * k / NOVEL_VIEWS)
        torch.cuda.synchronize()
        view_ms.append(1e3 * (time.perf_counter() - t0))
    fg = (views.min(-1) < 0.9).sum(axis=(1, 2))
    print(f"[viz_eval] render_turntable: {NOVEL_VIEWS} views of {Wf}x{Hf} "
          f"in {turntable_ms:.1f} ms, composite_fwd launches {launches_nv}; "
          f"a view timed alone (host clock, synchronised): "
          f"{', '.join(f'{x:.2f}' for x in view_ms)} ms, median "
          f"{np.median(view_ms):.2f}; foreground pixels a view {fg.tolist()}",
          flush=True)
    if launches_nv != NOVEL_VIEWS:
        raise AssertionError(f"[viz_eval] {launches_nv} composite_fwd launches "
                             f"for {NOVEL_VIEWS} novel views")
    if views.shape != (NOVEL_VIEWS, Hf, Wf, 3) or not (
            np.isfinite(views).all() and fg.min() > 1000):
        raise AssertionError("[viz_eval] a novel view is empty or not finite")

    with stages.record() as rec:
        render_novel_view(model, *inputs, view, K_full, Wf, Hf)
    names = ("carve", "unets", "select_head", "binning", "kernel", "untile")
    spans = {n: rec.spans[n][0] for n in names}
    b = rec.values["binning"][0]
    kept, dropped = int(b.counts.long().sum()), int(b.overflow)
    args = (b.inst, b.astarts, b.counts, b.origins, R.DEFAULT_TILE,
            R.DEFAULT_CHUNK, "conic")
    rgb_t, alpha_t, jstop, tb = K.composite_instances(*args, save_tbounds=True)
    ref = K.composite_instances_ref(*args, save_tbounds=True)
    err = max(float((rgb_t - ref[0]).abs().max()),
              float((alpha_t - ref[1]).abs().max()))
    tb_err = float((tb - ref[3]).abs().max())
    if not torch.equal(jstop, ref[2]):
        raise AssertionError("[viz_eval] jstop differs on the novel view")
    ms = cuda_ms(lambda: K.composite_instances(*args), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: K.composite_instances_ref(*args), iters=2)
    bound = kernel_bound(b.astarts, b.counts, jstop, R.DEFAULT_TILE,
                         R.DEFAULT_CHUNK)
    print(f"[viz_eval] one novel view's stages (each mark synchronising): "
          + " ".join(f"{'composite_fwd' if n == 'kernel' else n} "
                     f"{spans[n]:.2f}" for n in names)
          + f" ms | instance rows kept {kept}, dropped {dropped} (the "
          f"reference's per-camera cap 4N + T*G) | composite_fwd (conic) on "
          f"its arrays ({b.counts.numel()} tiles, {bound['busy_tiles']} busy, "
          f"{bound['walked_rows']} rows walked): max|kernel-plain| {err:.3g}, "
          f"tbounds {tb_err:.3g} (tol {TOL}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})", flush=True)
    if not (err <= TOL and tb_err <= TOL):
        raise AssertionError(f"[viz_eval] the novel view's kernel disagrees "
                             f"({err}, {tb_err})")
    out["novel_view"] = dict(
        width=Wf, height=Hf, views=NOVEL_VIEWS, launches=launches_nv,
        turntable_ms=turntable_ms, view_ms=view_ms,
        ms_a_view=float(np.median(view_ms)), foreground=fg.tolist(),
        stages_ms=spans, rows_kept=kept, rows_dropped=dropped,
        kernel=dict(max_abs_err=max(err, tb_err), ms=ms, plain_ms=plain_ms,
                    **bound))
    del rec, b, args, rgb_t, alpha_t, jstop, tb, ref, views

    # ---- (b) the evaluation's metrics and LPIPS, card against CPU ----
    t0 = time.perf_counter()
    pred = render_images_in_memory(model, data)
    render_ms = 1e3 * (time.perf_counter() - t0)
    gt = np.round(frames["img"] * 255).astype(np.uint8)
    path = str(out_dir / "lpips_random.npz")
    rng = np.random.default_rng(7)
    w, cin = {}, 3
    for i, (f, k, _, _) in enumerate(_ALEX_CFG):
        w[f"conv{i}_kernel"] = rng.normal(0, (cin * k * k) ** -0.5,
                                          (k, k, cin, f)).astype(np.float32)
        w[f"conv{i}_bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        w[f"lin{i}"] = rng.uniform(0, 1, f).astype(np.float32)
        cin = f
    np.savez(path, **w)
    runs = {}
    for d in ("cuda", "cpu"):
        lp = create_lpips(path, d)
        t0 = time.perf_counter()
        m = image_metrics(pred, gt, split="test", device=d)
        if d == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        m["lpips"] = lpips_metric(pred, gt, lp, split="test", device=d)
        if d == "cuda":
            torch.cuda.synchronize()
        runs[d] = dict(metrics=m, metrics_ms=1e3 * (t1 - t0),
                       lpips_ms=1e3 * (time.perf_counter() - t1))
    rel = {k: float(np.max(np.abs(runs["cuda"]["metrics"][k] - v)
                           / np.maximum(np.abs(v), 1e-30)))
           for k, v in runs["cpu"]["metrics"].items()}
    print(f"[viz_eval] evaluation of {pred.shape[0]} frames x {pred.shape[1]} "
          f"views at {W3}x{H3}: render_images_in_memory {render_ms:.1f} ms; "
          f"test-split metrics on the card {runs['cuda']['metrics_ms']:.1f} ms "
          f"(CPU {runs['cpu']['metrics_ms']:.1f}), LPIPS "
          f"{runs['cuda']['lpips_ms']:.1f} ms (CPU "
          f"{runs['cpu']['lpips_ms']:.1f}); card means "
          + ", ".join(f"{k} {float(np.mean(v)):.6f}"
                      for k, v in runs["cuda"]["metrics"].items())
          + "; card vs CPU relative "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (rtol {EVAL_RTOL})", flush=True)
    if not (max(rel.values()) <= EVAL_RTOL and pred[..., 3].max() > 128):
        raise AssertionError(f"[viz_eval] the metrics on the card disagree "
                             f"with the CPU ({rel})")
    out["evaluation"] = dict(frames=int(pred.shape[0]), render_ms=render_ms,
                             card={k: v.tolist() for k, v in
                                   runs["cuda"]["metrics"].items()},
                             rel_err=rel, **{f"{d}_{k}": runs[d][k]
                                             for d in runs for k in
                                             ("metrics_ms", "lpips_ms")})
    del pred

    # ---- (c) the export, card against a CPU twin of the model ----
    cpu_model = build_model(config, device="cpu", cameras=(Ks, Es))
    cpu_model.net.load_state_dict(model.net.state_dict())
    selected, got = {}, {}
    for name, mdl in (("cuda", model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        got[name] = extract_world_gaussians(mdl, *inputs)
        got[name + "_ms"] = 1e3 * (time.perf_counter() - t0)
        # The voxels that selection picked, in the export's order.
        with torch.no_grad():
            g, indices = mdl.frame_gaussians(*inputs)
        mdl.check_selection()
        selected[name] = indices[g["valid"]].cpu().numpy()
    n_card, n_cpu = len(got["cuda"]["means"]), len(got["cpu"]["means"])
    common, ic, ip = np.intersect1d(selected["cuda"], selected["cpu"],
                                    return_indices=True)
    errs = {}
    for k in ("means", "quaternions", "scales", "opacities", "colors"):
        a, c = got["cuda"][k][ic], got["cpu"][k][ip]
        errs[k] = float(np.abs(a - c).max() / np.abs(c).max())
    errs["center"] = float(np.abs(got["cuda"]["center"] - got["cpu"]["center"]
                                  ).max() / np.abs(got["cpu"]["center"]).max())
    written = {}
    for fmt, saver in SAVERS.items():
        fn = str(out_dir / f"gaussians_{fmt}.{EXTENSIONS[fmt]}")
        saver(got["cuda"], fn)
        written[fmt] = Path(fn).stat().st_size
    back = np.load(out_dir / "gaussians_npz.npz", allow_pickle=True)
    reloaded = all(np.array_equal(back[k], got["cuda"][k]) for k in
                   ("means", "quaternions", "scales", "opacities", "colors",
                    "center"))
    print(f"[viz_eval] extract_world_gaussians: card {n_card} Gaussians in "
          f"{got['cuda_ms']:.1f} ms, CPU {n_cpu} in {got['cpu_ms']:.1f} ms; "
          f"{len(common)} voxels selected by both, same order "
          f"{bool(np.array_equal(ic, ip))}; card vs CPU (of each array's "
          f"largest) " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {EXPORT_TOL}); files {written} bytes, npz read back "
          f"{reloaded}", flush=True)
    if not (n_card == n_cpu == len(common) and max(errs.values()) <= EXPORT_TOL
            and reloaded and min(written.values()) > 0):
        raise AssertionError("[viz_eval] the export on the card disagrees "
                             "with the CPU")
    out["export"] = dict(gaussians=n_card, common=int(len(common)),
                         same_order=bool(np.array_equal(ic, ip)),
                         rel_err=errs, card_ms=got["cuda_ms"],
                         cpu_ms=got["cpu_ms"], bytes=written)
    del cpu_model, got

    # ---- (d) profile_model and a trace on the 2D north star ----
    model2 = trained2["state"].model
    inputs2 = FrameSet(trained2["frames"], trained2["observed"]).get(
        0, view_idx=0)[:4]
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    prof = profile_model(model2, *inputs2, iters=PROFILE_ITERS)
    torch.cuda.synchronize()
    launches_prof = dict(composite_fwd=K.composite_instances.launches,
                         composite_bwd=K.composite_instances_bwd.launches)
    calls = PROFILE_ITERS + 2  # time_fn's warm-up calls included
    print(f"[viz_eval] profile_model (2D north star, 2D train phase's "
          f"weights, {PROFILE_ITERS} iterations): "
          + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in prof.items()})
          + f"; launches {launches_prof} ({calls} full_fwd_bwd calls)",
          flush=True)
    if launches_prof != dict(composite_fwd=3 * calls, composite_bwd=calls):
        raise AssertionError(f"[viz_eval] profile_model launched "
                             f"{launches_prof}")
    trace_dir = out_dir / "trace"
    for old in trace_dir.glob("*.json") if trace_dir.exists() else []:
        old.unlink()
    with trace(str(trace_dir)):
        fwd_bwd(model2, *inputs2)
    files = list(trace_dir.glob("*.pt.trace.json"))
    text = files[0].read_text() if len(files) == 1 else ""
    seen = {c: c in text for c in ("fwd_sum", "bwd_grad")}
    print(f"[viz_eval] trace of one fwd_bwd: {[f.name for f in files]}, "
          f"{len(text)} bytes, compositor kernels named in it {seen}",
          flush=True)
    if not text:
        raise AssertionError("[viz_eval] the trace is missing or empty")
    out["profile"] = dict(report=prof, launches=launches_prof,
                          trace_bytes=len(text), trace_kernels=seen)
    report["viz_eval_phase"] = out
    return out


def north_star_frame(config, frames, obs, k):
    """Frame k of ``frames`` as a batch of one, rendering observed view
    k mod len(obs) against itself."""
    j = k % len(obs)
    return dict(mask=frames["mask"][k:k + 1, obs],
                img=frames["img"][k:k + 1, obs],
                p_3d=frames["p_3d"][k:k + 1], angle=frames["angle"][k:k + 1],
                view_idx=np.array([obs[j]], np.int32),
                obs_idx=np.array([j], np.int32))


def parallel_phase(report, card):
    """Phase 16a (see the module docstring): the parallel package on the
    card, in a group of one rank over NCCL that it makes and destroys."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from pose_splatter_torch import graft_entry
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.ops.rasterize import DEFAULT_TILE, _alpha_ellipse
    from pose_splatter_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_train_step,
        replicate_state,
        shard_batch,
    )
    from pose_splatter_torch.parallel.launch import free_port
    from pose_splatter_torch.parallel.tile_sharding import (
        _composite_local,
        _padded_origins,
        make_tile_sharded_train_step,
    )
    from pose_splatter_torch.scripts import dbg_highres_sharded, scaling
    from pose_splatter_torch.train.loop import create_train_state, make_train_step
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.geometry import project_points, yaw_rotation

    dev = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cuda")
    out = dict(card=card, backend=dist.get_backend())
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        config = north_star_config()
        Ks, Es, frames = ring_scene(config, VIEWS, 4, seed=1)

        def twin(src=None, **kw):
            m = build_model(config, cameras=(Ks, Es), device=dev, seed=0, **kw)
            fresh_start(m)
            if src is not None:
                m.net.load_state_dict(src.net.state_dict())
            return m

        def counts():
            return (K.composite_instances.launches,
                    K.composite_instances_bwd.launches)

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, 1e3 * (time.perf_counter() - t)

        def zero():
            K.composite_instances.launches = 0
            K.composite_instances_bwd.launches = 0

        # (a) ------------------------------------------------------------
        a = twin()
        b = twin(a)
        obs = a.observed_views
        batches = [north_star_frame(config, frames, obs, k)
                   for k in range(PAR_DP_STEPS)]
        mesh = make_mesh()
        sa = replicate_state(create_train_state(a, config.lr), mesh)
        sb = create_train_state(b, config.lr)
        dp = make_sharded_train_step(a, sa.optimizer, config.img_lambda,
                                     config.ssim_lambda, mesh)
        plain = make_train_step(b, sb.optimizer, config.img_lambda,
                                config.ssim_lambda, batch_size=1)
        dp_loss, dp_ms, pl_loss, pl_ms = [], [], [], []
        # cuDNN held to deterministic algorithms, so that the twins can be
        # compared bit for bit (as the remat and bridge phases do).
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            zero()
            for batch in batches:
                (sa, m), ms = timed(lambda: dp(sa, shard_batch(batch, mesh)))
                dp_loss.append(float(m["total"]))
                dp_ms.append(ms)
            dp_launches = counts()
            for batch in batches:
                (sb, m), ms = timed(lambda: plain(sb, batch))
                pl_loss.append(float(m["total"]))
                pl_ms.append(ms)
        finally:
            torch.backends.cudnn.deterministic = saved
        w_diff = max(float((x - y).abs().max()) for x, y in zip(
            a.net.state_dict().values(), b.net.state_dict().values()))
        out["dp_step"] = dict(losses=dp_loss, plain_losses=pl_loss,
                              ms=dp_ms, plain_ms=pl_ms,
                              max_abs_weight_diff=w_diff,
                              launches=dict(zip(("composite_fwd",
                                                 "composite_bwd"),
                                                dp_launches)))
        print(f"[parallel] (a) {PAR_DP_STEPS} data-parallel steps at world 1 "
              f"({out['backend']}) against make_train_step, 2D north star: "
              f"losses {', '.join(f'{x:.6f}' for x in dp_loss)} / "
              f"{', '.join(f'{x:.6f}' for x in pl_loss)}, largest weight "
              f"difference {w_diff:.3g}; ms a step "
              f"{', '.join(f'{x:.1f}' for x in dp_ms)} / "
              f"{', '.join(f'{x:.1f}' for x in pl_ms)}; compositor launches "
              f"{dp_launches}", flush=True)
        if dp_loss != pl_loss or w_diff != 0 or dp_launches != (
                PAR_DP_STEPS, PAR_DP_STEPS):
            raise AssertionError("the data-parallel step at world 1 is not "
                                 "make_train_step, or skipped a kernel")
        del b, sb, plain

        # (b) ------------------------------------------------------------
        t = twin()
        kw = dict(render_mode="tiled")
        r = twin(t, **kw)
        r.tile_shape, r.tile_capacity = PAR_TILE, PAR_CAPACITY
        mesh11 = make_mesh((1, 1), ("data", "tile"))
        st = create_train_state(t, config.lr)
        sr = create_train_state(r, config.lr)
        stats0 = {k: v.clone() for k, v in t.net.named_buffers()}
        tile_step = make_tile_sharded_train_step(
            t, st.optimizer, config.img_lambda, config.ssim_lambda, mesh11,
            tile_shape=PAR_TILE, tile_capacity=PAR_CAPACITY, chunk=PAR_G,
            compositor="kernel")
        ref_step = make_train_step(r, sr.optimizer, config.img_lambda,
                                   config.ssim_lambda, batch_size=1)
        t_loss, t_ms, t_over, r_loss, r_over = [], [], [], [], []
        zero()
        for batch in batches[:PAR_TILE_STEPS]:
            (st, loss), ms = timed(lambda: tile_step(
                st, shard_batch(batch, mesh11, "data")))
            t_loss.append(float(loss))
            t_ms.append(ms)
            t_over.append(float(tile_step.overflow))
        tile_launches = counts()
        peak = torch.cuda.max_memory_allocated() - base
        for batch in batches[:PAR_TILE_STEPS]:
            sr, m = ref_step(sr, batch)
            r_loss.append(float(m["total"]))
            r_over.append(float(m["overflow"]))
        stats_same = all(torch.equal(v, stats0[k])
                         for k, v in t.net.named_buffers())
        rel = max(abs(x - y) / max(1.0, abs(y)) for x, y in zip(t_loss, r_loss))
        gap = abs(t_loss[0] - dp_loss[0])
        # A third step recorded for its kernels' arrays.
        with stages.record() as rec:
            st, _ = tile_step(st, shard_batch(batches[PAR_TILE_STEPS % len(
                batches)], mesh11, "data"))
        bargs = rec.values["kernel_bwd"][-1]
        inst, tbounds, astarts, cnts, origins, jstop = bargs[:6]
        tile, G, mode = bargs[8], bargs[9], bargs[10]
        fargs = (inst, astarts, cnts, origins, tile, G, mode)
        fg = K.composite_instances(*fargs, save_tbounds=True)
        fr = K.composite_instances_ref(*fargs, save_tbounds=True)
        fwd_err = max(float((x - y).abs().max()) for x, y in
                      ((fg[0], fr[0]), (fg[1], fr[1]), (fg[3], fr[3])))
        d = K.composite_instances_bwd(*bargs)
        d_ref = K.composite_instances_bwd_ref(*bargs)
        torch.cuda.synchronize()
        brel, btol = bwd_error(d, d_ref, jstop, tile, G)
        fwd_ms = cuda_ms(lambda: K.composite_instances(*fargs), 20, 2)
        fwd_plain_ms = cuda_ms(lambda: K.composite_instances_ref(*fargs), 2)
        bwd_ms = cuda_ms(lambda: K.composite_instances_bwd(*bargs), 20, 2)
        bwd_plain_ms = cuda_ms(lambda: K.composite_instances_bwd_ref(*bargs), 2)
        fb = kernel_bound(astarts, cnts, jstop, tile, G)
        bb = bwd_bound(inst, astarts, cnts, jstop, tile, G)
        out["tile_step"] = dict(
            losses=t_loss, ref_losses=r_loss, rel_err=rel, ms=t_ms,
            overflow=t_over, ref_overflow=r_over, stats_unchanged=stats_same,
            peak_bytes=peak, gap_to_kernel_main_path=gap,
            launches=dict(zip(("composite_fwd", "composite_bwd"),
                              tile_launches)),
            kernels=dict(fwd_max_abs_err=fwd_err, bwd_rel_err=brel,
                         bwd_tol=btol, bwd_max_abs_err=float(
                             (d - d_ref).abs().max()),
                         instance_rows=int(inst.shape[0]), tiles=int(
                             cnts.numel()), fwd_ms=fwd_ms,
                         fwd_plain_ms=fwd_plain_ms, fwd_bound=fb,
                         bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                         bwd_bound=bb))
        print(f"[parallel] (b) (data=1, tile=1) step, kernel compositor on "
              f"{PAR_TILE} tiles, G={PAR_G}, capacity {PAR_CAPACITY}: losses "
              f"{', '.join(f'{x:.6f}' for x in t_loss)} against the tiled "
              f"twin's {', '.join(f'{x:.6f}' for x in r_loss)} ({rel:.3g} "
              f"relative, tol {PAR_TILE_RTOL}); overflow {t_over} / {r_over}; "
              f"running statistics unchanged {stats_same}; ms a step "
              f"{', '.join(f'{x:.1f}' for x in t_ms)}; peak memory "
              f"{peak / 1e9:.3f} GB above the phase's start; launches "
              f"{tile_launches}; gap to the kernel-mode main path's first "
              f"loss {gap:.3g} (information: another tile and binning); on the "
              f"step's "
              f"arrays ({inst.shape[0]} rows, {cnts.numel()} tiles) the "
              f"forward kernel {fwd_ms:.4f} ms (plain {fwd_plain_ms:.2f} ms, "
              f"bound {fb['bound_ms']:.4f} ms) within {fwd_err:.3g} (tol "
              f"{TOL}), the backward {bwd_ms:.4f} ms (plain "
              f"{bwd_plain_ms:.2f} ms, bound {bb['bound_ms']:.4f} ms) within "
              f"{brel:.3g} of each column's largest (tol {btol:.3g})",
              flush=True)
        if not rel <= PAR_TILE_RTOL or t_over != r_over or not stats_same \
                or tile_launches != (PAR_TILE_STEPS, PAR_TILE_STEPS) \
                or not fwd_err <= TOL or not torch.equal(fg[2], fr[2]):
            raise AssertionError("the tile step disagrees with its tiled "
                                 "reference or its forward kernel with its "
                                 "plain version")
        if not brel <= btol:
            # The fresh start crowds thousands of Gaussians on a tile
            # (the overflow above), whose gradient columns cancel, as at
            # the highres fresh start: held against float64 there.
            out["tile_step"]["kernels"]["float64"] = bwd_float64_check(
                "parallel", d, d_ref, bargs, btol)
        del r, sr, ref_step, tile_step

        # (c) ------------------------------------------------------------
        batch = batches[0]
        with torch.no_grad():
            g, _ = a.frame_gaussians(batch["mask"][0], batch["img"][0],
                                     batch["p_3d"][0], batch["angle"][0])
            rot = yaw_rotation(a._tensor(batch["angle"][0]))
            anchors = g["anchor_means"] @ rot.T + a._tensor(batch["p_3d"][0])
            v = int(batch["view_idx"][0])
            means2d = project_points(anchors, a.Ks[v][None],
                                     a.viewmats[v][None], clamp_z=True)[0]
            means2d = means2d + g["means2d"]
            sc = torch.exp(g["log_scales2d"])
            radius = a.sigma_cutoff * torch.maximum(sc[:, 0], sc[:, 1])
            args = ((means2d, sc, g["rotation"],
                     torch.sigmoid(g["logit_opacities"])), g["colors"],
                    g["valid"], means2d, radius, _alpha_ellipse, DEFAULT_TILE,
                    PAR_CAPACITY, PAR_G, False, 0.0, "kernel")
            origins, n_ty, n_tx, pad = _padded_origins(
                H, W, DEFAULT_TILE, PAR_SHARDS, row_aligned=True, device=dev)
            T_real = n_ty * n_tx
            whole = _composite_local(origins[:T_real], *args)
            T_l = origins.shape[0] // PAR_SHARDS
            zero()
            parts = [_composite_local(origins[i * T_l:(i + 1) * T_l], *args)
                     for i in range(PAR_SHARDS)]
            shard_launches = counts()
            stitched = [torch.cat([p[j] for p in parts])[:T_real]
                        for j in range(2)]
        st_err = max(float((x - y).abs().max())
                     for x, y in zip(stitched, whole))
        out["rank_local"] = dict(shards=PAR_SHARDS, tiles=T_real, pad=pad,
                                 max_abs_err=st_err,
                                 launches=shard_launches[0],
                                 alpha_max=float(whole[1].max()))
        print(f"[parallel] (c) _composite_local on {PAR_SHARDS} row-aligned "
              f"shards of {T_real} tiles (+{pad} pad), stitched, against one "
              f"call over every tile: max|diff| {st_err:.3g} (tol "
              f"{PAR_STITCH_TOL}), {shard_launches[0]} forward launches, "
              f"alpha max {float(whole[1].max()):.3f}", flush=True)
        if not st_err <= PAR_STITCH_TOL or shard_launches[0] != PAR_SHARDS:
            raise AssertionError("the rank-local shards do not stitch into "
                                 "the whole render")
        del a, sa, dp, t, st

        # (d) ------------------------------------------------------------
        buf = io.StringIO()
        zero()
        with contextlib.redirect_stdout(buf):
            graft_entry.dryrun_multichip(1, device=dev)
        dry_launches = counts()
        lines = [x for x in buf.getvalue().splitlines() if " OK: " in x]
        for x in lines:
            print(f"[parallel] (d) {x}", flush=True)
        out["dryrun"] = dict(lines=lines, launches=dict(zip(
            ("composite_fwd", "composite_bwd"), dry_launches)))
        if len(lines) != 2 or dry_launches != (1, 1):
            raise AssertionError("dryrun_multichip(1) did not print its two "
                                 "lines or skipped the kernels")

        # (e) ------------------------------------------------------------
        with contextlib.redirect_stdout(io.StringIO()):
            sc_report = scaling.main([])
            hr = dbg_highres_sharded.main(["--devices", "1", "--steps", "2"])
        out["scaling"], out["highres"] = sc_report, hr
        row = sc_report["rows"][0]
        print(f"[parallel] (e) scripts/scaling.py: {row['steps_per_s']} "
              f"steps/s at 1 rank ({sc_report['config']}); "
              f"dbg_highres_sharded --devices 1: first step "
              f"{hr['first_step_s']:.3f} s, steady {hr['steady_step_s']:.3f} "
              f"s, loss {hr['loss']:.6f}, peak memory "
              f"{hr['peak_bytes_above_start'] / 1e9:.3f} GB ({hr['config']})",
              flush=True)
        if len(sc_report["rows"]) != 1 or not hr["loss_finite"]:
            raise AssertionError("the scaling script or the high-res probe "
                                 "failed")
    finally:
        dist.destroy_process_group()
    report["parallel_phase"] = out
    return out


# The probes in the order the phase runs them, each with its argv (its
# full default shape) and the compositor launches (forward, backward) it
# makes: a line launches on each of its 20 timed calls and one warm-up
# call (model lines: 5 and 1); see each probe's docstring.
PROBE_RUNS = (
    ("dbg_dispatch_floor", [], (0, 0)),
    # 5 forward lines, 2 of them with the backward; +1 recorded fwd+bwd.
    ("bench_breakdown", [], (5 * 21 + 1, 2 * 21 + 1)),
    ("dbg_rast_breakdown", [], (4 * 21, 2 * 21)),
    # kernel fwd, fwd empty, fwd+bwd, full fwd and 4 fwd+bwd lines.
    ("dbg_kernel_profile", ["64", "8", "128", "full"], (8 * 21, 5 * 21)),
    # 3 frames: the lifted cap, the default cap, then with gradients.
    ("dbg_vmap_kernel", [], (9, 3)),
    ("dbg_gather_bwd", [], (0, 0)),
    ("dbg_bin_micro", [], (0, 0)),
    ("dbg_carve_micro", [], (0, 0)),
    # full fwd, train step, grad thru render, grad full loss: 6 calls each.
    ("dbg_model_breakdown", [], (4 * 6, 3 * 6)),
    # 4 configurations of 6 train steps.
    ("dbg_step_bisect", [], (4 * 6, 4 * 6)),
)
VIS_GRID = 32


def visibility_card_vs_cpu():
    """``ray_cast_visibility`` on the card against the CPU, both methods,
    bit for bit, on a 32^3 grid of (k - 15.5)/32 coordinates, the
    occupied voxels a ball, seen by 4 cameras turned by quarter turns
    about y at distance 2 with f = 64 on 64x64 images: every coordinate,
    product and sum of the projection and the distances is exact in
    float32, and the division and square root are rounded the same way
    on both devices, so the two must agree exactly. The grid is
    symmetric about each camera's axis, so mirrored voxels lie at equal
    distances on one pixel: the sort gives such a tie to the lower voxel
    index, the segment method marks both (``ties_kept_by_segment``)."""
    import torch

    from pose_splatter_torch.ops import carving as C

    g = (torch.arange(VIS_GRID, dtype=torch.float32) - 15.5) / 32
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    occ = (pts ** 2).sum(-1) < 0.35 ** 2
    Es = torch.zeros((4, 4, 4))
    for i, (c, s_) in enumerate(((1, 0), (0, 1), (-1, 0), (0, -1))):
        Es[i, :3, :3] = torch.tensor([[c, 0, s_], [0, 1, 0], [-s_, 0, c]],
                                     dtype=torch.float32)
        Es[i, 2, 3], Es[i, 3, 3] = 2.0, 1.0
    Ks = torch.tensor([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]]).expand(4, 3, 3)
    out = {}
    for method in ("sort", "segment"):
        cpu = C.ray_cast_visibility(pts, occ, Ks, Es, 64, 64, method)
        card = C.ray_cast_visibility(pts.cuda(), occ.cuda(), Ks.cuda(),
                                     Es.cuda(), 64, 64, method).cpu()
        out[method] = dict(visible=int(cpu.sum()),
                           mismatches=int((cpu != card).sum()))
    out["ties_kept_by_segment"] = (out["segment"]["visible"]
                                   - out["sort"]["visible"])
    print(f"[probes] ray_cast_visibility card vs CPU on a {VIS_GRID}^3 grid "
          f"({int(occ.sum())} occupied, 4 cameras): {out}", flush=True)
    if any(out[m]["mismatches"] for m in ("sort", "segment")):
        raise AssertionError(f"ray_cast_visibility differs card vs CPU: {out}")
    return out


def probes_phase(report, card):
    """Phase 16b (see the module docstring): every stage-attribution
    probe's ``main`` at its full default shape, the compositors' launches
    read around each, and the checks the probes carry."""
    import importlib

    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K

    out = {}
    for name, argv, expect in PROBE_RUNS:
        mod = importlib.import_module(f"pose_splatter_torch.scripts.{name}")
        t = time.perf_counter()
        K.composite_instances.launches = 0
        K.composite_instances_bwd.launches = 0
        if name == "bench_breakdown":
            r = mod.run(record=True)
        else:
            r = mod.main(argv)
        torch.cuda.synchronize()
        launches = (K.composite_instances.launches,
                    K.composite_instances_bwd.launches)
        r = dict(r, launches=dict(zip(("composite_fwd", "composite_bwd"),
                                      launches)),
                 seconds=time.perf_counter() - t)
        rec = r.pop("recording", None)
        if launches != expect:
            raise AssertionError(f"[probes] {name}: compositor launches "
                                 f"{launches}, expected {expect}")
        if rec is not None:
            r["kernels"] = bench_kernels("probes bench_breakdown", rec, None)
        if name == "dbg_gather_bwd" and not r["allclose"]:
            raise AssertionError("[probes] dbg_gather_bwd: the two backward "
                                 "forms disagree")
        if name == "dbg_carve_micro" and not all(r["agree"].values()):
            raise AssertionError(f"[probes] dbg_carve_micro: the visibility "
                                 f"variants disagree: {r['agree']}")
        if name == "dbg_vmap_kernel" and not r["parity"]:
            raise AssertionError("[probes] dbg_vmap_kernel: no parity")
        lines = r.get("lines", {})
        head = (f"{len(lines)} lines, last {list(lines)[-1]} "
                f"{lines[list(lines)[-1]]:.4f} ms" if lines else
                f"parity {r.get('parity')}, fwd err "
                f"{r.get('fwd_max_abs_err', 0):.3g}, grad err "
                f"{r.get('grad_max_abs_err', 0):.3g}")
        print(f"[probes] {name}: {head}; compositor launches {launches}; "
              f"{r['seconds']:.1f} s; {card}", flush=True)
        out[name] = r
    out["visibility_card_vs_cpu"] = visibility_card_vs_cpu()
    report["probes_phase"] = out
    return out


def _leaves(tree):
    """The numpy leaves of a nested dict / tuple tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield np.asarray(tree)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gather-only", action="store_true",
                    help="build dyngather.cu and run only the gather phase "
                         "and its profile")
    ap.add_argument("--record", action="store_true",
                    help="build the compositors and the native decode, and "
                         "write the numbers kept in the repository "
                         "(TEMPORAL_torch*.json, INPUT_PIPELINE_torch.json) "
                         "into chiprun_out/")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from pose_splatter_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    from pose_splatter_torch.data import native

    names = (("dyngather",) if args.gather_only else
             ("composite_fwd", "composite_bwd", "carve_visibility")
             if args.record else
             ("composite_fwd", "composite_bwd", "carve_visibility",
              "dyngather"))
    t0 = time.perf_counter()
    # One nvcc a source and g++ for the native decode, all at once; a failed
    # build raises here.
    with ThreadPoolExecutor(len(names) + 1) as ex:
        fastio = (None if args.gather_only else ex.submit(native.build))
        libs = dict(zip(names, ex.map(_build.build, names)))
        fastio = fastio and fastio.result()
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(n + '.cu' for n in names)} in {build_s:.1f} s "
          f"({_build.CSRC})" + (f"; native decode {fastio}" if fastio else ""),
          flush=True)
    if fastio and native.route() != "native":
        raise AssertionError(f"the native decode built ({fastio}) but does "
                             "not load")
    for name, lib in libs.items():
        log = Path(str(lib) + ".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "smem")):
                print(f"  ptxas {name}: {line.strip()[:120]}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", line)
            if spills and any(int(g) for g in spills.groups()):
                raise AssertionError(f"{name}.cu spills registers: {line}")

    report = dict(card=card, build_s=build_s, phase_s={})
    res = {}
    if args.record:
        report = record_phase(report)
        report["total_s"] = time.perf_counter() - t_start
        (ROOT / "chiprun_out" / "record.json").write_text(
            json.dumps(report, indent=1))
        print(card)
        return 0

    def run(phase, fn, *args):
        t = time.perf_counter()
        res[phase] = fn(report, *args)
        report["phase_s"][phase] = time.perf_counter() - t
        print(f"phase {phase}: {report['phase_s'][phase]:.1f} s", flush=True)

    # torch.profiler runs only after every timed phase (``later``), so that
    # it cannot perturb what is timed.
    later = []
    run("dyngather", dyngather_phase, later)
    if not args.gather_only:
        run("kernels", kernel_phase)
        run("eval2d", eval_phase, "slice_phase", north_star_config(),
            "ellipse", later)
        cfg2 = north_star_config(
            project_directory=str(ROOT / "build" / "train"))
        assert (cfg2.lr, cfg2.img_lambda, cfg2.ssim_lambda) == (1e-4, 0.5, 0.1)
        run("train2d", train_phase, "train_phase", cfg2, K_STEPS, later)
        run("multistep2d", multistep_phase, "multistep2d_phase", cfg2,
            res["train2d"][2], later)
        run("eval3d", eval_phase, "eval3d_phase", config_3d(), "conic", later)
        cfg3 = config_3d(project_directory=str(ROOT / "build" / "train3d"))
        assert (cfg3.lr, cfg3.img_lambda, cfg3.ssim_lambda) == (1e-4, 0.5, 0.0)
        run("train3d", train_phase, "train3d_phase", cfg3, K_STEPS_3D, later)
        run("multistep3d", multistep_phase, "multistep3d_phase", cfg3,
            res["train3d"][2], later)
        run("bench", bench_phase, card, later)
        run("tiled", tiled_phase, card)
        run("synth", synth_phase)
        run("temporal", temporal_phase, later)
        run("input", input_phase)
        run("doctor", doctor_phase)
        run("carve_cap", carve_cap_phase, later)
        run("adaptive3d", adaptive3d_phase, card, later)
        run("remat2d", remat2d_phase, card, later)
        run("bridge", bridge_phase, res["train2d"][2])
        run("preprocess", preprocess_phase, res["train3d"][2])
        run("viz_eval", viz_eval_phase, res["train3d"][2], res["train2d"][2])
        run("parallel", parallel_phase, card)
        run("probes", probes_phase, card)
    run("profiled", lambda _: [measure() for measure in later])
    report["total_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    dg_launches, dg = res["dyngather"]
    gather_rows = [gather_row(dg, dg_launches, "dyngather_sum", 37),
                   gather_row(dg, dg_launches, "dyngather_once", 75)]
    if args.gather_only:
        report["result"] = kernels = {"kernels": gather_rows}
        (out / "chip_smoke_gather.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(kernels))
        print(card)
        return 0

    kp = res["kernels"]
    (eval_launches, sk), (train_launches, tk, _) = res["eval2d"], res["train2d"]
    (e3_launches, e3), (t3_launches, t3, _) = res["eval3d"], res["train3d"]
    m2, m3 = res["multistep2d"], res["multistep3d"]
    bench_lines = res["bench"]
    cap, ad3, rm2 = res["carve_cap"], res["adaptive3d"], res["remat2d"]
    vf = res["preprocess"]["kernel"]
    nv, nv_prof = (res["viz_eval"]["novel_view"],
                   res["viz_eval"]["profile"]["launches"])
    seq, inp = res["temporal"], res["input"]
    par = res["parallel"]
    pk = par["tile_step"]["kernels"]
    prb = res["probes"]
    prk = prb["bench_breakdown"]["kernels"]

    def bench_launches(kernel):
        return {f"launches_bench_{m}": bench_lines[f"{m}_kernel"]["launches"][
            kernel] for m in ("3d", "2d")}
    fwd_errs = [kp[m]["max_abs_err"] for m in kp] + [
        kp[m]["tbounds_max_abs_err"] for m in kp] + [
        sk["max_abs_err"], tk["fwd_max_abs_err"], e3["max_abs_err"],
        t3["fwd_max_abs_err"]] + [
        bench_lines[f"{m}_kernel"]["kernels"]["fwd_max_abs_err"]
        for m in ("3d", "2d")] + [
        ad3["kernels"]["fwd_max_abs_err"], rm2["kernels"]["fwd_max_abs_err"],
        vf["max_abs_err"], nv["kernel"]["max_abs_err"],
        seq["kernel"]["max_abs_err"], pk["fwd_max_abs_err"],
        par["rank_local"]["max_abs_err"], prk["fwd_max_abs_err"]]
    bwd_errs = [kp[m]["bwd_max_abs_err"] for m in kp] + [
        tk["max_abs_err"], t3["max_abs_err"]] + [
        bench_lines[f"{m}_kernel"]["kernels"]["bwd_max_abs_err"]
        for m in ("3d", "2d")] + [
        ad3["kernels"]["bwd_max_abs_err"], rm2["kernels"]["bwd_max_abs_err"],
        pk["bwd_max_abs_err"], prk["bwd_max_abs_err"]]

    def new_path_launches(kernel):
        out = dict(
            launches_carve_cap_multistep=cap["multistep_launches"][kernel],
            launches_adaptive_3d_train=ad3["train_launches"][kernel],
            launches_remat_2d=rm2["runs"]["remat"]["launches"][kernel])
        if kernel == "composite_fwd":
            out.update(launches_carve_cap_eval=cap["eval_launches"],
                       launches_adaptive_3d_eval=ad3["eval_launches"],
                       launches_rank_local=par["rank_local"]["launches"])
        out.update(launches_dp_step=par["dp_step"]["launches"][kernel],
                   launches_tile_step=par["tile_step"]["launches"][kernel],
                   launches_dryrun=par["dryrun"]["launches"][kernel],
                   launches_probes=sum(prb[name]["launches"][kernel]
                                       for name, _, _ in PROBE_RUNS))
        return out

    kernels = {"kernels": [
        dict(name="composite_fwd", route="cuda",
             source="pose_splatter_torch/csrc/composite_fwd.cu",
             replaces="pose_splatter_tpu/ops/rasterize_pallas.py:425",
             launches=train_launches["composite_fwd"],
             launches_eval_path=eval_launches,
             launches_3d_eval=e3_launches,
             launches_3d_train=t3_launches["composite_fwd"],
             **bench_launches("composite_fwd"),
             launches_multistep_2d=m2["launches"]["composite_fwd"],
             launches_multistep_3d=m3["launches"]["composite_fwd"],
             **new_path_launches("composite_fwd"),
             max_abs_err=max(fwd_errs),
             ms=sk["ms"], plain_ms=sk["plain_ms"], bound_ms=sk["bound_ms"],
             bound_by=sk["bound_by"], library_ms=None,
             ms_3d_eval=e3["ms"], plain_ms_3d_eval=e3["plain_ms"],
             bound_ms_3d_eval=e3["bound_ms"], bound_by_3d_eval=e3["bound_by"],
             ms_3d_train=t3["fwd_ms"], plain_ms_3d_train=t3["fwd_plain_ms"],
             bound_ms_3d_train=t3["fwd_bound"]["bound_ms"],
             cuda_launches_a_call=sk["split"]["launches_per_call"],
             past_jstop_share_3d_eval=e3["split"]["past_jstop_share"],
             launches_visual_features=res["preprocess"]["launches"],
             ms_visual_features=vf["ms"],
             plain_ms_visual_features=vf["plain_ms"],
             bound_ms_visual_features=vf["bound_ms"],
             bound_by_visual_features=vf["bound_by"],
             launches_novel_view=nv["launches"],
             ms_novel_view=nv["kernel"]["ms"],
             plain_ms_novel_view=nv["kernel"]["plain_ms"],
             bound_ms_novel_view=nv["kernel"]["bound_ms"],
             bound_by_novel_view=nv["kernel"]["bound_by"],
             launches_profile=nv_prof["composite_fwd"],
             launches_temporal=seq["launches"],
             launches_temporal_e2e=seq["launches_e2e"],
             max_abs_err_temporal=seq["kernel"]["max_abs_err"],
             ms_temporal=seq["kernel"]["ms"],
             plain_ms_temporal=seq["kernel"]["plain_ms"],
             bound_ms_temporal=seq["kernel"]["bound_ms"],
             bound_by_temporal=seq["kernel"]["bound_by"],
             launches_input=inp["launches"]["composite_fwd"],
             max_abs_err_tile_step=pk["fwd_max_abs_err"],
             ms_tile_step=pk["fwd_ms"], plain_ms_tile_step=pk["fwd_plain_ms"],
             bound_ms_tile_step=pk["fwd_bound"]["bound_ms"],
             bound_by_tile_step=pk["fwd_bound"]["bound_by"],
             max_abs_err_rank_local=par["rank_local"]["max_abs_err"]),
        dict(name="composite_bwd", route="cuda",
             source="pose_splatter_torch/csrc/composite_bwd.cu",
             replaces="pose_splatter_tpu/ops/rasterize_pallas.py:528",
             launches=train_launches["composite_bwd"],
             launches_3d_train=t3_launches["composite_bwd"],
             **bench_launches("composite_bwd"),
             launches_multistep_2d=m2["launches"]["composite_bwd"],
             launches_multistep_3d=m3["launches"]["composite_bwd"],
             **new_path_launches("composite_bwd"),
             max_abs_err=max(bwd_errs), ms=tk["ms"], plain_ms=tk["plain_ms"],
             bound_ms=tk["bound_ms"], bound_by=tk["bound_by"],
             library_ms=None, ms_3d_train=t3["ms"],
             plain_ms_3d_train=t3["plain_ms"], bound_ms_3d_train=t3["bound_ms"],
             bound_by_3d_train=t3["bound_by"],
             cuda_launches_a_call=tk["split"]["launches_per_call"],
             launches_profile=nv_prof["composite_bwd"],
             launches_input=inp["launches"]["composite_bwd"],
             max_abs_err_tile_step=pk["bwd_max_abs_err"],
             rel_err_tile_step=pk["bwd_rel_err"],
             ms_tile_step=pk["bwd_ms"], plain_ms_tile_step=pk["bwd_plain_ms"],
             bound_ms_tile_step=pk["bwd_bound"]["bound_ms"],
             bound_by_tile_step=pk["bwd_bound"]["bound_by"]),
        *gather_rows, visibility_row(cap["visibility"], report, m2, m3)]}
    report["result"] = kernels
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
