"""Repeated dynamic gather along one axis of a 2D table (counterpart of the
two Pallas probe kernels in ``scripts/dbg_dyngather_micro.py``).

    out[i, j] = sum_{r < reps} tab[idx[i, j] + r % 2, j]   (axis 0)
    out[i, j] = sum_{r < reps} tab[i, idx[i, j] + r % 2]   (axis 1)

in float32, summed sequentially in r from 0, as the TPU kernel's
``acc += take_along_axis(...)`` loop does. :func:`gather_sum` is
``_run_kernel``'s function; :func:`gather` is ``probe_correct``'s, the same
function with ``reps = 1``. One CUDA source serves both
(``csrc/dyngather.cu``); each wrapper counts its own launches.

On a CUDA tensor a wrapper checks its inputs and launches the kernel (built
at first use); on a CPU tensor it runs :func:`gather_sum_ref`, the plain
version. The two add in the same order, so they are bit-equal. There is no
fallback between them. An index outside the table raises, as
``torch.take_along_dim`` does; nothing is clamped. The range check reads
the indices' extremes back to the host, one synchronisation a call. Every
launch goes through :func:`launch`, which counts it in the wrapper's
``launches`` and returns the path the C entry took: "vector" (16-byte
accesses, one quad of 4 elements a thread) where L % 4 == 0 and the three
tensors are 16-byte aligned, else "scalar" (one element a thread); "none"
for an empty table, which launches nothing. Both paths add in the same
order, so the path never changes a result.
"""

from __future__ import annotations

import ctypes

import torch

MAX_ROW = 12288  # axis 1: a row is staged in 48 KB of shared memory


def gather_sum_ref(tab: torch.Tensor, idx: torch.Tensor, axis: int,
                   reps: int) -> torch.Tensor:
    """Plain PyTorch version: a loop of ``torch.take_along_dim`` and ``+=``."""
    idx = idx.long()
    out = torch.zeros_like(tab)
    for r in range(reps):
        out += torch.take_along_dim(tab, idx + r % 2, dim=axis)
    return out


def _check(tab, idx, axis: int, reps: int):
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if tab.dim() != 2 or tab.shape != idx.shape:
        raise ValueError(f"tab {tuple(tab.shape)} and idx {tuple(idx.shape)} "
                         "must be 2D of one shape")
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"expected a float32 table and int32 indices, got "
                        f"{tab.dtype} and {idx.dtype}")
    if idx.device != tab.device:
        raise ValueError(f"idx is on {idx.device}, tab on {tab.device}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tab.device}")
    dim = tab.shape[axis]
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi + (reps > 1) >= dim:
            raise IndexError(f"index range [{lo}, {hi}] + offsets up to "
                             f"{int(reps > 1)} is outside [0, {dim}) on "
                             f"axis {axis}")
    if axis == 1 and tab.shape[1] > MAX_ROW:
        raise ValueError(f"axis 1 takes rows of at most {MAX_ROW} floats")


_ENTRY = None  # the C entry, bound with its argument types at first launch
_PATHS = {-1: "scalar", -2: "vector"}  # the C entry's codes of a launch


def _bind():
    """Build (if needed) and load ``csrc/dyngather.cu`` and bind its C
    entry, once."""
    global _ENTRY
    from pose_splatter_torch.ops import _build

    fn = _build.load("dyngather").dyngather
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p] + [ctypes.c_int] * 4 + [p]
    fn.restype = ctypes.c_int
    _ENTRY = fn
    return fn


def launch(wrapper, tab: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
           axis: int, reps: int) -> str:
    """Launch ``csrc/dyngather.cu`` into ``out`` on the current stream, add
    one to ``wrapper.launches`` and return the path the kernel took
    ("vector" or "scalar"): the one way into the kernel, so every launch is
    counted. An empty table launches nothing, counts nothing and returns
    "none". It checks nothing else: a wrapper checks its CUDA tensors on
    every call, and a timing loop calls a wrapper once on its tensors first.
    It enters the tensors' device only when that is not the current one."""
    S, L = tab.shape
    if S * L == 0:
        return "none"
    fn = _ENTRY or _bind()
    index = tab.device.index
    args = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), S, L, axis, reps,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(index):
            rc = fn(*args)
    path = _PATHS.get(rc)
    if path is None:
        raise RuntimeError(f"dyngather launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return path


def _run(tab, idx, axis: int, reps: int, wrapper) -> torch.Tensor:
    _check(tab, idx, axis, reps)
    if tab.device.type == "cpu":
        return gather_sum_ref(tab, idx, axis, reps)
    out = torch.empty_like(tab)
    launch(wrapper, tab, idx, out, axis, reps)
    return out


def gather_sum(tab: torch.Tensor, idx: torch.Tensor, axis: int,
               reps: int) -> torch.Tensor:
    """``sum_{r<reps} take_along_dim(tab, idx + r % 2, axis)``: tab [S, L]
    float32, idx [S, L] int32, both contiguous on one device; counts CUDA
    launches in ``gather_sum.launches``."""
    return _run(tab, idx, axis, reps, gather_sum)


gather_sum.launches = 0


def gather(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """One ``take_along_dim(tab, idx, axis)`` (``gather_sum`` with reps 1);
    counts CUDA launches in ``gather.launches``."""
    return _run(tab, idx, axis, 1, gather)


gather.launches = 0
