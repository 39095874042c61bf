"""Shared set-up of the benchmark's tests: the ``cuda`` marker, and cells
cut to a size the CPU runs in seconds (written to a temporary directory
beside the benchmark's own files, as a later change would add one)."""

import copy
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

TINY = dict(image_width=64, image_height=64, image_downsample=1, grid_size=16,
            volume_idx=[[0, 16], [0, 16], [0, 16]], min_n=16, max_n=256)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a CUDA device")


def tiny_cell(root: Path, like: str, name: str = None, **workload):
    """A cell like ``like`` at the tiny size: its config and workload files
    under ``root`` and its entry in a copy of BENCHMARK.json. Returns
    (cell, bench, registry)."""
    bench = copy.deepcopy(harness.load_bench())
    entry = next(w for w in bench["workloads"] if w["name"] == like)
    name = name or f"{like}-tiny"
    cfg_name = f"{entry['config']}_tiny"
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    cfg = json.loads((harness.HERE / "configs" / f"{entry['config']}.json").read_text())
    cfg.update(TINY)
    (root / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
    wl = json.loads((harness.HERE / "workloads" / f"{like}.json").read_text())
    wl.update(config=cfg_name, frames=4, poses=4)
    wl.update(workload)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    bench["configs"].append(dict(name=cfg_name, source="tiny", file="x",
                                 reduced=[], why="tiny"))
    bench["workloads"].append(dict(entry, name=name, config=cfg_name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    registry = harness.Registry([root, harness.HERE])
    return harness.load_cell(name, bench, registry), bench, registry


@pytest.fixture
def tiny(tmp_path):
    return lambda like, **kw: tiny_cell(tmp_path, like, **kw)[0]
