"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.

Module names are compared by their whole top-level name (the part before
the first dot): the program's package name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pose_splatter_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every module ``path`` imports, anywhere in it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20
    assert BENCH / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "pose_splatter_torch" not in names
    # Only the standard library, numpy, torch and the reference itself.
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference")


def test_the_walk_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom jax import numpy\nimport pose_splatter_torch.ops\n")
    assert imported(bad) == {"os", "jax", "pose_splatter_torch"}
    # The port's name starts with the JAX package's; whole names differ.
    assert "pose_splatter_torch" not in FORBIDDEN
