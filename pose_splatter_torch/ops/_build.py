"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the repository root (listed in ``.gitignore``) the first time a kernel is
launched, never at import, and loaded with ``ctypes``. The library's file
name carries a hash of the source, the headers beside it and the flags, so
an edited source is rebuilt and a stale library is never loaded.
``compile_cached`` also builds the native frame decode
(``data/native.py``) with ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math (expf stays the accurate one). FMA contraction is off so
# the kernel rounds like its plain PyTorch version, which runs unfused ops.
# ``-Xptxas -v`` reports registers, shared memory and spills into the
# build log written beside the library.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, every header in
    ``csrc/`` (a source may include any of them) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def compile_cached(out: Path, command: Callable[[str], List[str]],
                   what: str) -> Path:
    """Run ``command(tmp)``, which writes a library to the path ``tmp``,
    unless ``out`` already exists; move the result to ``out`` and return it.
    The compiler's messages go to ``<out>.log``; a failed build raises with
    them. ``out``'s name carries a hash of what was compiled, so an
    existing file is never stale."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run(command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{what} failed:\n{proc.stderr}")
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path. ``nvcc``'s messages go to ``<library>.log``;
    a failed build raises with them."""
    return compile_cached(
        library_path(name),
        lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                     str(CSRC / f"{name}.cu")],
        f"nvcc for {name}.cu")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
