"""ctypes bindings of the host-side frame decode (the counterpart of
``pose_splatter_tpu/data/native.py``; the port imports nothing of the JAX
package).

Wraps ``csrc/fastio.cpp``: a one-pass multithreaded uint8 → float decode
with the white-background mask, and the preprocessing white-out. ``g++``
compiles it with the JAX package's Makefile flags into ``build/native/`` at
the repository root (listed in ``.gitignore``) the first time it is used,
never at import. The library's name carries a hash of the source, the
flags and the host CPU (``-march=native`` code may not run on another
one), so an edited source is rebuilt and a library built elsewhere is
never loaded. The JAX package's ``native/`` directory is never written.

Every entry point has a NumPy version beside it (``decode_frame_numpy``,
``white_out_numpy``), taken when the library does not build. The two
decodes differ: the library scales by ``r * (1/255)`` and NumPy divides by
255, which differs by one ulp on 126 of the 256 byte values; the masks are
equal. :func:`route` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from pose_splatter_torch.ops._build import CSRC, compile_cached

SOURCE = CSRC / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's CXXFLAGS and its -shared.
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()  # the loader's threads decode concurrently


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _host_cpu()).hexdigest()
    return BUILD_DIR / f"libfastio_{digest[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fastio.cpp`` unless its library is already built;
    return the library's path. Raises if there is no ``g++`` or it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native decode is built with a "
                           "C++ compiler")
    return compile_cached(
        library_path(), lambda tmp: [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
        "g++ for fastio.cpp")


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once a process; None if it does not
    build or load (the NumPy versions run then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            return None
        lib.decode_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.decode_frame.restype = None
        lib.white_out.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.white_out.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def route() -> str:
    """``"native"`` where the library builds and loads, else ``"numpy"``:
    the route :func:`decode_frame` and :func:`white_out` take."""
    return "native" if available() else "numpy"


def _threads(n_threads: int, C: int) -> int:
    return n_threads if n_threads > 0 else min(C, len(os.sched_getaffinity(0)))


def decode_frame_numpy(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [C,H,W,3] → (mask [C,H,W] f32, img [C,H,W,3] f32 = raw / 255)."""
    img = raw.astype(np.float32) / 255.0
    mask = np.where(img[..., 0] == 1.0, 0.0, 1.0).astype(np.float32)
    return mask, img


def decode_frame(raw: np.ndarray, n_threads: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [C,H,W,3] → (mask [C,H,W] f32, img [C,H,W,3] f32 in [0,1]),
    one thread a view up to the CPUs this process may use."""
    lib = _load()
    if lib is None:
        return decode_frame_numpy(raw)
    raw = np.ascontiguousarray(raw)
    if raw.dtype != np.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
        raise ValueError(f"expected uint8 [C,H,W,3], got {raw.dtype} "
                         f"{raw.shape}")
    C, H, W, _ = raw.shape
    mask = np.empty((C, H, W), np.float32)
    img = np.empty((C, H, W, 3), np.float32)
    lib.decode_frame(
        raw.ctypes.data_as(ctypes.c_void_p), C, H, W,
        mask.ctypes.data_as(ctypes.c_void_p),
        img.ctypes.data_as(ctypes.c_void_p), _threads(n_threads, C),
    )
    return mask, img


def white_out_numpy(frames: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """In place: frames [C,H,W,3] u8 turn white where masks [C,H,W] < 128."""
    frames[masks < 128] = np.array([255, 255, 255], np.uint8)
    return frames


def white_out(frames: np.ndarray, masks: np.ndarray,
              n_threads: int = 0) -> np.ndarray:
    """In-place white-out of frames [C,H,W,3] u8 where masks [C,H,W] < 128
    (a contiguous copy of ``frames`` is written and returned if it was not
    contiguous, as in the JAX package)."""
    lib = _load()
    if lib is None:
        return white_out_numpy(frames, masks)
    frames = np.ascontiguousarray(frames)
    masks = np.ascontiguousarray(masks)
    if (frames.dtype != np.uint8 or masks.dtype != np.uint8
            or frames.ndim != 4 or frames.shape[-1] != 3
            or masks.shape != frames.shape[:3]):
        raise ValueError(f"expected uint8 frames [C,H,W,3] and masks [C,H,W], "
                         f"got {frames.dtype} {frames.shape} and "
                         f"{masks.dtype} {masks.shape}")
    C, H, W, _ = frames.shape
    lib.white_out(
        frames.ctypes.data_as(ctypes.c_void_p),
        masks.ctypes.data_as(ctypes.c_void_p), C, H, W,
        _threads(n_threads, C),
    )
    return frames
