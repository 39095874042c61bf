"""Every public name and script of the JAX package has a counterpart in
the port, read from the sources with ``ast`` (neither package is
imported): each public top-level ``def`` / ``class`` of a module of
``pose_splatter_tpu/`` is bound at the top level of the port's module of
the same path, and every ``scripts/*.py`` has a
``pose_splatter_torch/scripts/`` counterpart. What keeps the roadmap's
"Queue A is empty" checkable."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "pose_splatter_tpu"
PORT = ROOT / "pose_splatter_torch"

# The port's names for the JAX package's Pallas pieces: the TPU's Pallas
# kernels became hand-written CUDA kernels, so "pallas" became "kernel".
MODULE_RENAMES = {"ops/rasterize_pallas.py": "ops/rasterize_kernels.py"}
NAME_RENAMES = {"composite_instances_pallas": "composite_instances"}
SCRIPT_RENAMES = {"dbg_pallas_profile.py": "dbg_kernel_profile.py",
                  "dbg_vmap_pallas.py": "dbg_vmap_kernel.py"}
# Runs inside Blender on the exported files, which the port's savers
# write byte for byte as the JAX package's do, so it serves both.
SCRIPT_EXCEPTIONS = {"blender_import_pointcloud.py"}


def _public_defs(path: Path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _bound(path: Path):
    """Every name bound at the module's top level."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port = PORT / MODULE_RENAMES.get(rel, rel)
    assert port.exists(), f"no counterpart of pose_splatter_tpu/{rel}"
    want = {NAME_RENAMES.get(n, n) for n in _public_defs(JAX_PKG / rel)}
    missing = sorted(want - _bound(port))
    assert not missing, f"{port.relative_to(ROOT)} lacks {missing}"


def test_every_script_has_a_counterpart():
    scripts = {p.name for p in (ROOT / "scripts").glob("*.py")}
    assert SCRIPT_EXCEPTIONS <= scripts and set(SCRIPT_RENAMES) <= scripts
    ported = {p.name for p in (PORT / "scripts").glob("*.py")}
    missing = sorted(s for s in scripts - SCRIPT_EXCEPTIONS
                     if SCRIPT_RENAMES.get(s, s) not in ported)
    assert not missing, f"scripts without a counterpart: {missing}"


def test_the_renames_name_what_exists():
    """Each rename's JAX side exists, so the map cannot go stale."""
    for rel, port in MODULE_RENAMES.items():
        assert (JAX_PKG / rel).exists() and (PORT / port).exists()
    defs = set().union(*(_public_defs(JAX_PKG / r) for r in JAX_MODULES))
    assert set(NAME_RENAMES) <= defs
