"""Environment check-up (counterpart of ``scripts/doctor.py``).

Usage: python -m pose_splatter_torch.scripts.doctor [--device cuda|cpu]

Checks torch and the package's version; the card (name, compute capability,
power limit), ``nvcc`` and each ``csrc/*.cu`` built through
``ops/_build.build``, every source and the native frame decode compiled at
once, each kernel failing where its ``ptxas`` log reports a register
spill or is missing; the native frame decode (optional, as in the JAX
script); the optional packages of the JAX script's list plus ``h5py`` and
``PIL``; and a tiny
``rasterize`` forward and backward, through the hand-written kernels on the
card (their launches counted) or through their plain versions with
``--device cpu``. On the CPU the card, ``nvcc`` and the kernels are
reported but not required. Exits 1 when a required check fails.
"""

from __future__ import annotations

import argparse
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

from pose_splatter_torch.scripts.common import add_device

OPTIONAL = [("cv2", "video preprocessing"),
            ("zarr", "zarr datasets"),
            ("matplotlib", "plots"),
            ("sklearn", "embedding PCA/t-SNE"),
            ("joblib", "parallel preprocessing"),
            ("rerun", "rerun viewer"),
            ("h5py", "images.h5 datasets"),
            ("PIL", "PNG frames")]


def check(label, fn):
    try:
        detail = fn()
        print(f"[OK  ] {label}" + (f": {detail}" if detail else ""))
        return True
    except Exception as e:  # noqa: BLE001 - every failure is reported
        print(f"[FAIL] {label}: {type(e).__name__}: {e}")
        return False


def imports():
    import torch

    import pose_splatter_torch

    return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
            f"pose_splatter_torch {pose_splatter_torch.__version__}")


def card():
    import torch

    from pose_splatter_torch.scripts.common import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    major, minor = torch.cuda.get_device_capability(0)
    return (f"{torch.cuda.get_device_name(0)}, compute capability "
            f"{major}.{minor}, nvidia-smi: {card_line()}")


def nvcc():
    from pose_splatter_torch.ops import _build

    return _build.nvcc_path()


def spills(log: str) -> List[str]:
    """The lines of a ``ptxas -v`` log that report spill stores or loads
    of more than 0 bytes."""
    out = []
    for line in log.splitlines():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and any(int(g) for g in m.groups()):
            out.append(line.strip())
    return out


def kernel(name, built):
    """The library that ``built`` (a future of ``_build.build(name)``)
    gives, failing where its build log reports a spill or is missing."""
    def run():
        lib = built.result()
        log = Path(str(lib) + ".log")
        if not log.exists():
            raise RuntimeError(f"{name}.cu's build log {log.name} is "
                               "missing, so its spills are unchecked")
        bad = spills(log.read_text())
        if bad:
            raise RuntimeError(f"{name}.cu spills registers: {bad[0]}")
        return f"{lib}, no spills"

    return run


def native(built):
    """The native decode's library, once ``built`` (a future of its build)
    is done, loaded."""
    def run():
        from pose_splatter_torch.data import native as n

        built.result()
        if not n.available():
            raise RuntimeError("libfastio did not build; the NumPy decode runs")
        return str(n.library_path())

    return run


def smoke(device):
    """One 3D Gaussian rendered at 32x32 by ``rasterize`` in kernel mode,
    and the gradient of the image's sum by its opacity."""
    import torch

    from pose_splatter_torch.ops import rasterize_kernels as K
    from pose_splatter_torch.ops.rasterize import rasterize

    def run():
        dev = torch.device(device)
        before = (K.composite_instances.launches,
                  K.composite_instances_bwd.launches)
        o = torch.tensor([0.8], device=dev, requires_grad=True)
        Ks = torch.tensor([[[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]]],
                          device=dev)
        rgb, _ = rasterize(
            torch.tensor([[0.0, 0.0, 2.0]], device=dev),
            torch.tensor([[1.0, 0, 0, 0]], device=dev),
            torch.full((1, 3), 0.05, device=dev), o,
            torch.ones((1, 3), device=dev), torch.eye(4, device=dev)[None],
            Ks, 32, 32, mode="kernel")
        rgb.sum().backward()
        assert float(o.grad[0]) != 0.0, "zero gradient"
        if dev.type == "cuda":
            launched = (K.composite_instances.launches - before[0],
                        K.composite_instances_bwd.launches - before[1])
            assert launched == (1, 1), f"kernel launches {launched}"
            return "fwd+bwd rasterize through composite_fwd / composite_bwd"
        return "fwd+bwd rasterize through the plain versions (cpu)"

    return run


def build_parser() -> argparse.ArgumentParser:
    return add_device(argparse.ArgumentParser(description=__doc__))


def main(argv=None):
    args = build_parser().parse_args(argv)
    on_card = args.device != "cpu"

    ok = check("core imports", imports)
    tag = "" if on_card else " (optional with --device cpu)"
    needed = check("card" + tag, card)
    needed &= check("nvcc" + tag, nvcc)
    from pose_splatter_torch.data import native as n
    from pose_splatter_torch.ops import _build

    names = [src.stem for src in sorted(_build.CSRC.glob("*.cu"))]
    # One nvcc a source and g++ for the native decode, all at once.
    with ThreadPoolExecutor(len(names) + 1) as ex:
        fastio = ex.submit(n.build)
        built = [ex.submit(_build.build, name) for name in names]
        for name, future in zip(names, built):
            needed &= check(f"kernel {name}.cu{tag}", kernel(name, future))
        check("native fastio (optional)", native(fastio))
    if on_card:
        ok &= needed

    for mod, why in OPTIONAL:
        def probe(mod=mod, why=why):
            __import__(mod)
            return why

        check(f"optional: {mod}", probe)

    ok &= check("rasterizer smoke test", smoke(args.device))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
