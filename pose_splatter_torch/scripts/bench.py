"""Benchmark: forward+backward rasterizer throughput on one GPU
(counterpart of the repository's ``bench.py``).

    python -m pose_splatter_torch.scripts.bench [--mode 3d|2d] [--batch N]
        [--device cuda|cpu]

Workload: 576x512 with 16000 Gaussians, value and gradient through every
Gaussian parameter of sum(rgb^2) + sum(alpha^2), on ``bench.py``'s seed-0
scenes (the same numpy draws in the same order): ``--mode 3d`` (the
default) the conic renderer on a mouse-like cluster, ``--mode 2d`` the
ellipse renderer with a fresh Gaussian set per frame. ``--batch N``
renders N frames a call.

On the card it runs ``"kernel"`` mode (the hand-written compositors, the
counterpart of ``"pallas"`` on the TPU); on the CPU ``"tiled"``, as
``bench.py`` does off the TPU. TF32 is off, as in every entry point.

Prints one JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``baseline``) and ``device_ms``:

- ``value``: Mpix/s by the host clock, timed as ``bench.py::_bench`` times
  it: one warm-up call, then the best of 4 batches of 30 calls, each batch
  ending in ``torch.cuda.synchronize()``. What a caller of ``rasterize``
  pays, the host's Python included.
- ``device_ms``: the device time of one fwd+bwd: the call captured once as
  a CUDA graph (as ``train/loop.py::MultiStep`` captures a train step) and
  the graph replayed between CUDA events. Null on the CPU, where there is
  no device time to take.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops.rasterize import rasterize, rasterize_2d
from pose_splatter_torch.utils.device import resolve_device

BASELINE_MPIX_S = 0.0369
H, W = 512, 576
N = 16000
BASELINE = ("reference torch 2D renderer, 0.0369 Mpix/s "
            "(CONFIGURATION_GUIDE.md:78); its gsplat CUDA path publishes "
            "no per-frame figure")
METRICS = {"3d": "rasterize_fwd_bwd_throughput",
           "2d": "rasterize2d_fwd_bwd_throughput"}
GRAPH_REPLAYS = 20


def scene_3d(batch: int, H: int = H, W: int = W, N: int = N, seed: int = 0):
    """``bench.py::run_3d``'s inputs as float32 numpy arrays: means, quats,
    scales, opacities, colours, viewmats [batch,4,4], Ks [batch,3,3]
    (``bench.py`` draws them with seed 0)."""
    rng = np.random.default_rng(seed)
    # Mouse-like cluster: Gaussians concentrated in the central third.
    means = np.concatenate(
        [rng.normal(0, 0.06, (N, 2)), rng.normal(2.0, 0.06, (N, 1))], axis=1)
    quats = rng.normal(size=(N, 4))
    scales = np.exp(rng.normal(-5.0, 0.3, (N, 3)))
    opac = rng.uniform(0.3, 0.95, N)
    colors = rng.uniform(0, 1, (N, 3))
    f = 900.0
    K = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * batch,
                 np.float32)
    view = np.stack([np.eye(4, dtype=np.float32)] * batch)
    return tuple(np.asarray(a, np.float32)
                 for a in (means, quats, scales, opac, colors, view, K))


def scene_2d(batch: int, H: int = H, W: int = W, N: int = N):
    """``bench.py::run_2d``'s inputs: per-frame means2d [batch,N,2],
    scales2d [batch,N,2], rotations, opacities [batch,N], colours
    [batch,N,3], float32."""
    rng = np.random.default_rng(0)
    means2d = np.stack([
        np.stack([rng.uniform(0.2 * W, 0.8 * W, N),
                  rng.uniform(0.2 * H, 0.8 * H, N)], 1)
        for _ in range(batch)])
    scales2d = np.exp(rng.normal(0.7, 0.3, (batch, N, 2)))  # ~2 px sigmas
    rot = rng.uniform(0, np.pi, (batch, N))
    opac = rng.uniform(0.3, 0.95, (batch, N))
    colors = rng.uniform(0, 1, (batch, N, 3))
    return tuple(np.asarray(a, np.float32)
                 for a in (means2d, scales2d, rot, opac, colors))


def _mode(render_mode: Optional[str], dev: torch.device) -> str:
    return render_mode or ("kernel" if dev.type == "cuda" else "tiled")


def fwd_bwd_3d(batch: int = 1, render_mode: Optional[str] = None,
               device="cuda", H: int = H, W: int = W, N: int = N):
    """``(fn, args)``: ``fn(*args)`` is one fwd+bwd of the 3D scene and
    returns the gradients of means, quats, scales, opacities, colours."""
    dev = resolve_device(device)
    mode = _mode(render_mode, dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in scene_3d(batch, H, W, N))
    bg = torch.ones(3, device=dev)

    def fn(*a):
        ps = [x.detach().requires_grad_() for x in a[:5]]
        rgb, alpha = rasterize(*ps, a[5], a[6], W, H, backgrounds=bg,
                               mode=mode)
        loss = (rgb ** 2).sum() + (alpha ** 2).sum()
        return torch.autograd.grad(loss, ps)

    return fn, args


def fwd_bwd_2d(batch: int = 1, render_mode: Optional[str] = None,
               device="cuda", H: int = H, W: int = W, N: int = N):
    """``(fn, args)`` for the 2D scene: each frame's Gaussians rendered on
    their own (``bench.py`` vmaps the frames), the losses summed."""
    dev = resolve_device(device)
    mode = _mode(render_mode, dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in scene_2d(batch, H, W, N))
    bg = torch.ones(3, device=dev)

    def fn(*a):
        ps = [x.detach().requires_grad_() for x in a]
        loss = 0.0
        for b in range(ps[0].shape[0]):
            rgb, alpha = rasterize_2d(*(p[b] for p in ps), W, H,
                                      background=bg, mode=mode)
            loss = loss + (rgb ** 2).sum() + (alpha ** 2).sum()
        return torch.autograd.grad(loss, ps)

    return fn, args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_seconds(fn: Callable, args: Sequence[torch.Tensor], iters: int = 30,
                 reps: int = 4) -> float:
    """``bench.py::_bench``: a warm-up call, then the best of ``reps``
    batches of ``iters`` calls by the host clock, each batch ending in a
    device synchronize; seconds a call."""
    dev = args[0].device
    fn(*args)
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def graph_device_ms(fn: Callable, args: Sequence[torch.Tensor],
                    replays: int = GRAPH_REPLAYS) -> float:
    """Device ms of one call: warm-up calls on a side stream, the call
    captured as one CUDA graph, the graph replayed ``replays`` times
    between CUDA events. A capture that fails raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def result_line(mode: str, batch: int, seconds: float, device_ms,
                H: int = H, W: int = W) -> dict:
    """``bench.py``'s JSON line, with ``device_ms`` beside it."""
    mpix_s = H * W * batch / seconds / 1e6
    return {
        "metric": METRICS[mode],
        "value": round(mpix_s, 3),
        "unit": "Mpix/s/chip",
        "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 2),
        "baseline": BASELINE,
        "device_ms": device_ms,
    }


def measure(mode: str = "3d", batch: int = 1,
            render_mode: Optional[str] = None, device="cuda", H: int = H,
            W: int = W, N: int = N, iters: int = 30, reps: int = 4,
            replays: int = GRAPH_REPLAYS):
    """One mode's fwd+bwd, timed: ``(host seconds a call, device ms a call
    or None off the card, fn, args)``, ``fn(*args)`` being the fwd+bwd."""
    setup = fwd_bwd_2d if mode == "2d" else fwd_bwd_3d
    fn, args = setup(batch, render_mode, device, H, W, N)
    seconds = host_seconds(fn, args, iters, reps)
    device_ms = (graph_device_ms(fn, args, replays)
                 if args[0].device.type == "cuda" else None)
    return seconds, device_ms, fn, args


def run(mode: str = "3d", batch: int = 1, **kw) -> dict:
    """``measure`` as ``bench.py``'s JSON line (keywords as ``measure``)."""
    seconds, device_ms, _, _ = measure(mode, batch, **kw)
    return result_line(mode, batch, seconds, device_ms,
                       kw.get("H", H), kw.get("W", W))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="3d", choices=["2d", "3d"])
    ap.add_argument("--batch", type=int, default=1, help="frames a call")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernel mode) or cpu (tiled mode)")
    cli = ap.parse_args(argv)
    seconds, device_ms, _, _ = measure(cli.mode, cli.batch,
                                       device=cli.device)
    dev = torch.device(cli.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"fwd+bwd rasterize[{cli.mode}, batch={cli.batch}]: "
          f"{seconds * 1e3:.3f} ms a call by the host clock, "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'}"
          f" on the device, on {name}", file=sys.stderr)
    line = result_line(cli.mode, cli.batch, seconds, device_ms)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
