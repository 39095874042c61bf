#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in the checkout
(``nvcc``, one process a source, all at once), then:

1. card: prints the GPU's name and power limit and the build time;
2. dyngather: the probe entry point (``pose_splatter_torch.scripts.
   dbg_dyngather_micro``: ``probe_correct`` on both axes and the three
   probe lines) with both gather wrappers' launches read around it; then
   the kernel against its plain version, bit for bit, at [2304, 128] on
   both axes for reps 32 and 1, timed with CUDA events beside
   ``torch.take_along_dim``;
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
   the user-facing entry points, with the forward kernel's launch count read
   around them, then a per-frame breakdown from the forward's own stage
   marks (``pose_splatter_torch.utils.stages``) and a kernel-vs-plain check
   on the instance arrays that the forward binned, with how the kernel
   spread over the card there (``split_stats``: chunks walked and evaluated
   past a tile's stop, scratch bytes, CUDA launches a call by
   ``torch.profiler``, ms beside the one-block-a-tile kernel's it replaced);
5. 2D train slice: ``train_from_config`` at the same configuration (fresh
   start, lr 1e-4, img_lambda 0.5, ssim_lambda 0.1, batch 1) for K steps on
   synthetic frames, with both kernels' launch counts read around it and
   each step's stages recorded; then unrecorded steps, timed whole with the
   launches read around each; then the backward kernel against its plain
   version on the last step's own instance arrays, ``tbounds`` and loss
   gradient;
6. 3D eval and 3D train: the same two phases for the 3D Gaussian model,
   ``configs/templates/tpu_3d.json`` as written (288x256, grid 112, crop
   96x80x64, 6 cameras, holdout views [5, 1], 3 U-Nets of base width 8, up
   to 16000 Gaussians; lr 1e-4, img_lambda 0.5, ssim_lambda 0): projection,
   depth sort and both compositors in conic mode;
7. bench shape: the 3D rasterizer alone at 576x512 with 16000 Gaussians
   (``bench.py::run_3d``'s seed-0 cluster, f = 900), forward and backward
   through means, quats, scales, opacities and colours, ms and Mpix/s;
   then both compositors alone on the arrays it binned (``split_stats``);
8. profiled: what ``torch.profiler`` measures, deferred to after every
   timed phase: each compositor call's device operations and their device
   time (``split_stats``), and the card's busy share of one more train
   step in each mode and of a bench-shape fwd+bwd (``device_busy``).

Prints one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no CUDA device or any phase fails. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
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
# Train slices: steps driven through train_from_config, then steps timed
# whole outside any recording.
K_STEPS = 8
K_EXTRA = 3
K_STEPS_3D = 6
EXTRA_PASSES = 3  # passes over the K_EXTRA frames timed whole


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_busy(fn):
    """Wall ms of one call of ``fn`` under ``torch.profiler`` (ending in a
    synchronize) and the ms its device operations took (one stream, so
    they do not overlap): how far the host holds the card back."""
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
                kernels=len(evs))


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
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import (
        FrameSet,
        ring_cameras,
        synthetic_frames,
    )

    Wc, Hc = config.render_width, config.render_height
    Ks, Es = ring_cameras(VIEWS, Wc, Hc, focal=800.0 * Wc / W, radius=0.6)
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

    grid = create_3d_grid(config.ell, config.grid_size, config.volume_idx)
    crop_center = grid.reshape(-1, 3).mean(0)
    n_frames = 3
    frames = synthetic_frames(Ks, Es, Hc, Wc, crop_center, (0.055, 0.032, 0.028),
                              n_frames, seed=0)
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
    t0 = time.perf_counter()
    rgba = render_images_in_memory(model, data)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, metrics = step(batch)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = K.composite_instances.launches
    # ---------------------------------------------------------------
    print(f"[{key}] main path: render_images_in_memory {n_frames} frames x "
          f"{VIEWS} views in {1e3 * t_render:.1f} ms, make_eval_step "
          f"{n_frames} frames in {1e3 * t_eval:.1f} ms; composite_fwd "
          f"launches {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path never launched composite_fwd")
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
            before = K.composite_instances.launches
            t_all = time.perf_counter()
            rgb_e, alpha_e, overflow_e = model(mask, img, p_3d, angle,
                                               view_idx, return_overflow=True)
            runs.append(sync_ms(t_all))
            if r == 0:
                per_forward = K.composite_instances.launches - before
        whole = float(np.median(runs))
        with stages.record() as rec:
            model(mask, img, p_3d, angle, view_idx)
        st = dict(rec.ms)
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
                   kernel_launches_per_forward=per_forward, loss_view0=float(tl))
        frames_out.append(out)
        print(f"[{key}] frame {i}: forward {whole:.2f} ms (median of "
              f"{', '.join(f'{x:.2f}' for x in runs)}), {per_forward} "
              f"composite_fwd launch(es) | "
              + " ".join(f"{k} {v:.2f}" for k, v in st.items())
              + f" ms | gaussians {n_valid}/{g['valid'].numel()} overflow "
              f"{int(overflow_e)} instances {out['instances']} | loss(view "
              f"{obs}) {float(tl):.5f}", flush=True)
        if not torch.isfinite(rgb_e).all() or not torch.isfinite(alpha_e).all():
            raise AssertionError("non-finite render")
        if per_forward <= 0:
            raise AssertionError("the forward never launched composite_fwd")
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
        launches=launches, render_ms=1e3 * t_render, eval_step_ms=1e3 * t_eval,
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
    from pose_splatter_torch.config import Config

    cfg = json.loads((ROOT / "configs" / "templates" / "tpu_3d.json").read_text())
    cfg.update(overrides)
    config = Config(cfg)
    assert config.gaussian_mode == "3d"
    assert (config.render_width, config.render_height) == (W3, H3)
    return config


def dyngather_bound(S: int, L: int, reps: int):
    """Least time on an H100 for the repeated gather: the table, the indices
    and the output once each against the reps - 1 float32 adds of every
    element (the first term needs no add)."""
    nbytes = 3 * S * L * 4
    ops = (reps - 1) * S * L
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return dict(bytes=nbytes, ops=ops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def dyngather_phase(report):
    """The probe entry point with the gather wrappers' launches read around
    it, then the kernel against its plain version (bit for bit) and its
    time beside the plain version's and ``torch.take_along_dim``'s."""
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
    rng = np.random.default_rng(5)
    rows = {}
    for name, reps in (("dyngather_sum", probe.REPS), ("dyngather_once", 1)):
        per_axis = {}
        for axis in (0, 1):
            dim = S if axis == 0 else L
            tab = torch.from_numpy(rng.random((S, L), dtype=np.float32)).to(dev)
            idx = torch.from_numpy(rng.integers(
                0, dim - (reps > 1), (S, L)).astype(np.int32)).to(dev)

            wrapped_fn = D.gather if reps == 1 else D.gather_sum

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
            r = dict(
                axis=axis, reps=reps, bit_equal=equal,
                max_abs_err=float((got - ref).abs().max()),
                # The kernel alone (the wrapper checked these inputs above).
                ms=cuda_ms(lambda: D.launch(wrapped_fn, tab, idx, out, axis,
                                             reps), 500, 20),
                # The wrapper, with its index check's read-back.
                wrapper_ms=cuda_ms(wrapped, 100, 5),
                plain_ms=cuda_ms(lambda: D.gather_sum_ref(tab, idx, axis, reps),
                                 20, 2),
                library_ms=(cuda_ms(lambda: torch.take_along_dim(
                    tab, idx_long, dim=axis), 500, 20) if reps == 1 else None),
                **dyngather_bound(S, L, reps))
            per_axis[axis] = r
            lib = ("" if r["library_ms"] is None else
                   f", torch.take_along_dim {r['library_ms']:.5f} ms")
            print(f"[dyngather] {name} axis {axis} reps {reps} [{S}, {L}]: "
                  f"bit-equal {equal} | kernel {r['ms']:.5f} ms, wrapper "
                  f"{r['wrapper_ms']:.5f} ms, plain {r['plain_ms']:.4f} ms"
                  f"{lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                  flush=True)
            if not equal:
                raise AssertionError(f"dyngather {name} axis {axis}: kernel "
                                     "differs from the plain version")
        rows[name] = per_axis
    report["dyngather_phase"] = dict(launches=launches, probe=res, rows=rows)
    return launches, rows


def bench3d_phase(report, card, later):
    """The 3D rasterizer alone at bench.py's shape: 576x512, 16000
    Gaussians of ``run_3d``'s seed-0 cluster, f = 900, one camera; forward
    and backward of sum(rgb^2) + sum(alpha^2) through every Gaussian
    parameter."""
    import torch

    from pose_splatter_torch.ops import rasterize as R
    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.utils import stages

    rng = np.random.default_rng(0)
    means = np.concatenate([rng.normal(0, 0.06, (N_GAUSS, 2)),
                            rng.normal(2.0, 0.06, (N_GAUSS, 1))], axis=1)
    quats = rng.normal(size=(N_GAUSS, 4))
    scales = np.exp(rng.normal(-5.0, 0.3, (N_GAUSS, 3)))
    opac = rng.uniform(0.3, 0.95, N_GAUSS)
    colors = rng.uniform(0, 1, (N_GAUSS, 3))
    f = 900.0
    dev = torch.device("cuda")

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    params = [t(x) for x in (means, quats, scales, opac, colors)]
    Ks = t([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]])
    view = t(np.eye(4)[None])
    bg = torch.ones(3, device=dev)

    def fwd_bwd():
        ps = [p.detach().requires_grad_(True) for p in params]
        rgb, alpha, overflow = R.rasterize(*ps, view, Ks, W, H, backgrounds=bg,
                                           mode="kernel", return_overflow=True)
        loss = (rgb ** 2).sum() + (alpha ** 2).sum()
        return loss.detach(), overflow, torch.autograd.grad(loss, ps)

    fwd_bwd()  # warm-up: allocator, sort and gather workspaces
    torch.cuda.synchronize()
    # ---- the bench path, with the launch counts zeroed around it ----
    K.composite_instances.launches = 0
    K.composite_instances_bwd.launches = 0
    loss, overflow, grads = fwd_bwd()
    torch.cuda.synchronize()
    launches = dict(composite_fwd=K.composite_instances.launches,
                    composite_bwd=K.composite_instances_bwd.launches)
    # ---------------------------------------------------------------
    if launches != dict(composite_fwd=1, composite_bwd=1):
        raise AssertionError(f"bench shape: launches {launches}, expected one "
                             "of each kernel")
    if not np.isfinite(float(loss)) or not all(
            torch.isfinite(g).all() for g in grads):
        raise AssertionError("bench shape: non-finite loss or gradient")
    runs = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(runs))
    event_ms = cuda_ms(fwd_bwd, iters=20, warmup=0)
    # Both kernels alone on the arrays this shape bins (one recorded run).
    with stages.record() as rec:
        fwd_bwd()
    bargs = rec.values["kernel_bwd"][0]
    inst, tb, astarts, counts, origins, jstop = bargs[:6]
    tile, G = bargs[8], bargs[9]
    fargs = (inst, astarts, counts, origins, tile, G, "conic")
    fwd_ms = cuda_ms(lambda: K.composite_instances(*fargs, save_tbounds=True),
                     20, 2)
    bwd_ms = cuda_ms(lambda: K.composite_instances_bwd(*bargs), 20, 2)
    kernels = dict(
        fwd=split_stats("bench3d", "composite_fwd", inst.shape[0], counts,
                        jstop, tile, G, fwd_ms,
                        kernel_bound(astarts, counts, jstop, tile, G)["bound_ms"],
                        lambda: K.composite_instances(*fargs, save_tbounds=True),
                        later),
        bwd=split_stats("bench3d", "composite_bwd", inst.shape[0], counts,
                        jstop, tile, G, bwd_ms,
                        bwd_bound(inst, astarts, counts, jstop, tile, G)["bound_ms"],
                        lambda: K.composite_instances_bwd(*bargs), later))
    busy = {}
    out = dict(loss=float(loss), overflow=int(overflow), launches=launches,
               ms_median=ms, ms_runs=runs, event_ms=event_ms,
               mpix_s=H * W / ms / 1e3, card=card, kernels=kernels,
               device_busy=busy)
    print(f"[bench3d] 3D rasterize fwd+bwd at {W}x{H}, {N_GAUSS} Gaussians: "
          f"{ms:.3f} ms (median of 20, host clock; CUDA events {event_ms:.3f} "
          f"ms), {out['mpix_s']:.3f} Mpix/s, overflow {int(overflow)}, "
          f"launches {launches}, loss {float(loss):.4f} on {card}", flush=True)

    def bench_busy():
        busy.update(device_busy(fwd_bwd))
        print(f"[bench3d] under torch.profiler the card was busy "
              f"{busy['busy_ms']:.2f} ms of a {busy['wall_ms']:.2f} ms "
              f"fwd+bwd", flush=True)

    later.append(bench_busy)
    report["bench3d_phase"] = out
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

    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.train.loop import make_train_step
    from pose_splatter_torch.train.trainer import train_from_config
    from pose_splatter_torch.utils import stages
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import (
        FrameSet,
        ring_cameras,
        synthetic_frames,
    )
    from pose_splatter_torch.data.dataset import FrameLoader

    Wc, Hc = config.render_width, config.render_height
    Ks, Es = ring_cameras(VIEWS, Wc, Hc, focal=800.0 * Wc / W, radius=0.6)
    grid = create_3d_grid(config.ell, config.grid_size, config.volume_idx)
    t0 = time.perf_counter()
    frames = synthetic_frames(Ks, Es, Hc, Wc, grid.reshape(-1, 3).mean(0),
                              (0.055, 0.032, 0.028), k_steps + K_EXTRA, seed=1)
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
    t0 = time.perf_counter()
    with stages.record() as rec:
        state, losses, _ = train_from_config(
            config, epochs=1, max_batches=k_steps, batch_size=1, seed=0,
            device="cuda", cameras=(Ks, Es), datasets=(train, valid))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = dict(composite_fwd=K.composite_instances.launches,
                    composite_bwd=K.composite_instances_bwd.launches)
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
          + f" ms; launches {launches}", flush=True)
    if n != k_steps or state.step != k_steps:
        raise AssertionError(f"{n} steps recorded, state at {state.step}")
    if min(launches.values()) < k_steps:
        raise AssertionError(f"a kernel was not launched every step: {launches}")
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
                  K.composite_instances_bwd.launches)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        extra.append(dict(step_ms=ms, loss=float(m["total"]),
                          fwd_launches=K.composite_instances.launches - before[0],
                          bwd_launches=K.composite_instances_bwd.launches - before[1]))
    whole_ms = float(np.median([e["step_ms"] for e in extra]))
    print(f"[{key}] unrecorded steps: " + "; ".join(
        f"{e['step_ms']:.2f} ms, loss {e['loss']:.6f}, composite_fwd "
        f"{e['fwd_launches']} / composite_bwd {e['bwd_launches']} launch(es)"
        for e in extra) + f"; median {whole_ms:.2f} ms", flush=True)
    if any(e["fwd_launches"] != 1 or e["bwd_launches"] != 1 for e in extra):
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
        launches=launches, train_from_config_s=t_train, steps=steps,
        median_after_warmup=med, stage_medians_ms=med_stages,
        unrecorded_steps=extra, unrecorded_median_ms=whole_ms,
        step_device_busy=busy, epoch_losses=losses,
        main_path_kernel=main_kernel,
        peak_memory_gb=(torch.cuda.max_memory_allocated() - base_bytes) / 1e9)
    print(f"[{key}] train peak device memory "
          f"{report[key]['peak_memory_gb']:.2f} GB", flush=True)
    return launches, main_kernel


def main() -> int:
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
    names = ("composite_fwd", "composite_bwd", "dyngather")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:  # one nvcc a source, at once
        libs = dict(zip(names, ex.map(_build.build, names)))
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(n + '.cu' for n in names)} in {build_s:.1f} s",
          flush=True)
    for name, lib in libs.items():
        log = Path(str(lib) + ".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "smem")):
                print(f"  ptxas {name}: {line.strip()[:120]}")

    report = dict(card=card, build_s=build_s, phase_s={})
    res = {}

    def run(phase, fn, *args):
        t = time.perf_counter()
        res[phase] = fn(report, *args)
        report["phase_s"][phase] = time.perf_counter() - t
        print(f"phase {phase}: {report['phase_s'][phase]:.1f} s", flush=True)

    run("dyngather", dyngather_phase)
    run("kernels", kernel_phase)
    # torch.profiler runs only after every timed phase (``later``), so that
    # it cannot perturb what is timed.
    later = []
    run("eval2d", eval_phase, "slice_phase", north_star_config(), "ellipse",
        later)
    cfg2 = north_star_config(project_directory=str(ROOT / "build" / "train"))
    assert (cfg2.lr, cfg2.img_lambda, cfg2.ssim_lambda) == (1e-4, 0.5, 0.1)
    run("train2d", train_phase, "train_phase", cfg2, K_STEPS, later)
    run("eval3d", eval_phase, "eval3d_phase", config_3d(), "conic", later)
    cfg3 = config_3d(project_directory=str(ROOT / "build" / "train3d"))
    assert (cfg3.lr, cfg3.img_lambda, cfg3.ssim_lambda) == (1e-4, 0.5, 0.0)
    run("train3d", train_phase, "train3d_phase", cfg3, K_STEPS_3D, later)
    run("bench3d", bench3d_phase, card, later)
    run("profiled", lambda _: [measure() for measure in later])
    report["total_s"] = time.perf_counter() - t_start

    (dg_launches, dg), kp = res["dyngather"], res["kernels"]
    (eval_launches, sk), (train_launches, tk) = res["eval2d"], res["train2d"]
    (e3_launches, e3), (t3_launches, t3) = res["eval3d"], res["train3d"]
    b3 = res["bench3d"]
    fwd_errs = [kp[m]["max_abs_err"] for m in kp] + [
        kp[m]["tbounds_max_abs_err"] for m in kp] + [
        sk["max_abs_err"], tk["fwd_max_abs_err"], e3["max_abs_err"],
        t3["fwd_max_abs_err"]]
    bwd_errs = [kp[m]["bwd_max_abs_err"] for m in kp] + [
        tk["max_abs_err"], t3["max_abs_err"]]

    def gather_row(name, line):
        a0, a1 = dg[name][0], dg[name][1]
        return dict(
            name=name, route="cuda",
            source="pose_splatter_torch/csrc/dyngather.cu",
            replaces=f"scripts/dbg_dyngather_micro.py:{line}",
            launches=dg_launches["gather_sum" if a0["reps"] > 1 else "gather"],
            max_abs_err=max(a0["max_abs_err"], a1["max_abs_err"]),
            ms=a0["ms"], plain_ms=a0["plain_ms"], bound_ms=a0["bound_ms"],
            bound_by=a0["bound_by"], library_ms=a0["library_ms"],
            reps=a0["reps"], ms_axis1=a1["ms"], plain_ms_axis1=a1["plain_ms"],
            library_ms_axis1=a1["library_ms"], wrapper_ms=a0["wrapper_ms"])

    kernels = {"kernels": [
        dict(name="composite_fwd", route="cuda",
             source="pose_splatter_torch/csrc/composite_fwd.cu",
             replaces="pose_splatter_tpu/ops/rasterize_pallas.py:425",
             launches=train_launches["composite_fwd"],
             launches_eval_path=eval_launches,
             launches_3d_eval=e3_launches,
             launches_3d_train=t3_launches["composite_fwd"],
             launches_bench3d=b3["launches"]["composite_fwd"],
             max_abs_err=max(fwd_errs),
             ms=sk["ms"], plain_ms=sk["plain_ms"], bound_ms=sk["bound_ms"],
             bound_by=sk["bound_by"], library_ms=None,
             ms_3d_eval=e3["ms"], plain_ms_3d_eval=e3["plain_ms"],
             bound_ms_3d_eval=e3["bound_ms"], bound_by_3d_eval=e3["bound_by"],
             ms_3d_train=t3["fwd_ms"], plain_ms_3d_train=t3["fwd_plain_ms"],
             bound_ms_3d_train=t3["fwd_bound"]["bound_ms"],
             cuda_launches_a_call=sk["split"]["launches_per_call"],
             past_jstop_share_3d_eval=e3["split"]["past_jstop_share"]),
        dict(name="composite_bwd", route="cuda",
             source="pose_splatter_torch/csrc/composite_bwd.cu",
             replaces="pose_splatter_tpu/ops/rasterize_pallas.py:528",
             launches=train_launches["composite_bwd"],
             launches_3d_train=t3_launches["composite_bwd"],
             launches_bench3d=b3["launches"]["composite_bwd"],
             max_abs_err=max(bwd_errs), ms=tk["ms"], plain_ms=tk["plain_ms"],
             bound_ms=tk["bound_ms"], bound_by=tk["bound_by"],
             library_ms=None, ms_3d_train=t3["ms"],
             plain_ms_3d_train=t3["plain_ms"], bound_ms_3d_train=t3["bound_ms"],
             bound_by_3d_train=t3["bound_by"],
             cuda_launches_a_call=tk["split"]["launches_per_call"]),
        gather_row("dyngather_sum", 37),
        gather_row("dyngather_once", 75)]}
    report["result"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
