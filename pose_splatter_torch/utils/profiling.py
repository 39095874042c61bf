"""Profiling: stage timings, throughput and ``torch.profiler`` traces
(counterpart of ``pose_splatter_tpu/utils/profiling.py``).

- ``time_fn``: mean wall-clock seconds a call, the card synchronised
  before each clock read.
- ``trace``: a context manager around ``torch.profiler`` that writes a
  Chrome / TensorBoard trace (``*.pt.trace.json``) into a directory.
- ``fwd_bwd``: one full forward and backward of a frame, what
  ``profile_model`` times as a train step and ``trace`` can record.
- ``profile_model``: the PoseSplatter pipeline stage by stage (carve,
  U-Nets, Gaussian extraction, render, full forward, full forward and
  backward) with Mpix/s and steps/s, as a dict with the JAX function's
  keys (what ``scripts/profile.py`` prints).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch

from pose_splatter_torch.utils.geometry import yaw_rotation


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            **kwargs) -> float:
    """Mean seconds a call of ``fn(*args, **kwargs)`` over ``iters`` calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("out/trace"):`` records the block with
    ``torch.profiler`` (the CPU, and the card where one is in use) and
    writes a Chrome / TensorBoard trace file into ``log_dir``."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        _sync()


def fwd_bwd(model, mask, img, p_3d, angle, params=None):
    """One full forward and backward: the gradients of Σrgb² + Σα² of view
    0 with respect to ``params`` (default: every parameter of the net; None
    for those the loss does not reach), the U-Nets' BatchNorm on its
    running statistics (eval mode), as the JAX ``loss`` is
    (``profiling.py:104-110``)."""
    if params is None:
        params = list(model.net.parameters())
    with torch.enable_grad():
        rgb, alpha, _, _ = model._forward(mask, img, p_3d, angle, 0, None)
        loss = (rgb ** 2).sum() + (alpha ** 2).sum()
        return torch.autograd.grad(loss, params, allow_unused=True)


def profile_model(model, mask, img, p_3d, angle,
                  iters: int = 10) -> Dict[str, Any]:
    """Stage-by-stage timing of one frame's pipeline on the model's device
    (the full forward and backward is :func:`fwd_bwd`)."""
    H, W = model.H, model.W
    params = list(model.net.parameters())

    @torch.no_grad()
    def carve():
        return model.carve(mask, img, p_3d, angle)

    t_carve = time_fn(carve, iters=iters)
    volume = carve().permute(1, 2, 3, 0)[None]

    @torch.no_grad()
    def process():
        return model.net.process_volume(volume)

    t_unet = time_fn(process, iters=iters)
    vol_flat = process()

    @torch.no_grad()
    def extract():
        return model.gaussians_from_volume(vol_flat)

    t_extract = time_fn(extract, iters=iters)

    @torch.no_grad()
    def render():
        g = model.gaussians_from_volume(vol_flat)
        if model.gaussian_mode == "3d":
            g = model.apply_pose_transform_3d(g, angle, p_3d)
        elif "anchor_means" in g:
            # Anchored 2D: pose-transform the anchors as the forward does.
            rot = yaw_rotation(angle, model.device)
            g["anchor_means"] = g["anchor_means"] @ rot.T + model._tensor(p_3d)
        return model.render(g, [0])

    t_render = time_fn(render, iters=iters)

    def full():
        return model(mask, img, p_3d, angle, 0)[0]

    t_full = time_fn(full, iters=iters)

    t_grad = time_fn(fwd_bwd, model, mask, img, p_3d, angle, params,
                     iters=iters)
    model.check_selection()

    mpix = H * W / 1e6
    return {
        "image": f"{W}x{H}",
        "grid": list(model.input_size),
        "max_gaussians": model.max_n,
        "carve_ms": t_carve * 1e3,
        "unet_ms": t_unet * 1e3,
        "extract_ms": t_extract * 1e3,
        "render_fwd_ms": t_render * 1e3,
        "full_fwd_ms": t_full * 1e3,
        "full_fwd_bwd_ms": t_grad * 1e3,
        "render_mpix_s": mpix / t_render,
        "train_step_s": t_grad,
        "train_steps_per_s": 1.0 / t_grad,
    }
