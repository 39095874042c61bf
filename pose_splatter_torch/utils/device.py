"""Device selection and CUDA-event timing for the port's entry points."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and none
    is present (entry points never fall back to the CPU quietly).

    On CUDA this also turns TF32 off for cuDNN convolutions and matmuls: the
    port runs in true float32, as the JAX package forces
    ``Precision.HIGHEST`` where it matters (SSIM's variance estimates).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean milliseconds a call of ``fn`` over ``iters`` calls, timed with
    CUDA events on the current stream after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn: Callable[[], object], device: Union[str, torch.device],
            iters: int, warmup: int = 1) -> float:
    """Mean milliseconds a call of ``fn``: :func:`cuda_ms` on a CUDA device;
    on the CPU, which computes as it is called, the host clock over the
    ``iters`` calls after ``warmup`` (a time of the CPU, not of a card)."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def card_line(device: Union[str, torch.device] = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(index)} (power limit not read: {e})"
    return out.stdout.strip().splitlines()[index]
