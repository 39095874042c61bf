"""The port's bench (``pose_splatter_torch/scripts/bench.py``) against the
repository's JAX ``bench.py``, on the CPU at a small size.

The JAX script is loaded from its file with importlib, its ``H``, ``W``
and ``N`` set small on the module object (the file is not touched) and its
``_bench`` replaced on the module object by a stub that keeps the jitted
fwd+bwd and its inputs instead of timing them. Both sides run ``"tiled"``
mode, as ``bench.py`` does off the TPU: the scenes must be equal and the
gradients within 1e-3 of each tensor's largest entry. The 3D scene's conic
gates hold no pixel-Gaussian pair within float32 rounding of a gate.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.scripts import bench as tb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(H=40, W=72, N=150)


@pytest.fixture()
def jbench(monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in SMALL.items():
        monkeypatch.setattr(mod, k, v)
    seen = {}

    def keep(fwd_bwd, args, **kw):
        seen.update(fn=fwd_bwd, args=args)
        return 0.01

    monkeypatch.setattr(mod, "_bench", keep)
    return mod, seen


@pytest.mark.parametrize("mode,batch", [("3d", 1), ("2d", 2)])
def test_scene_and_gradients_match_jax(jbench, mode, batch):
    mod, seen = jbench
    elapsed, metric = (mod.run_3d if mode == "3d" else mod.run_2d)(batch)
    assert metric == tb.METRICS[mode]
    scene = (tb.scene_3d if mode == "3d" else tb.scene_2d)(batch, **SMALL)
    assert len(scene) == len(seen["args"])
    for a, b in zip(seen["args"], scene):
        np.testing.assert_array_equal(np.asarray(a), b)
    jg = seen["fn"](*seen["args"])
    fn, args = (tb.fwd_bwd_3d if mode == "3d" else tb.fwd_bwd_2d)(
        batch, "tiled", "cpu", **SMALL)
    tg = fn(*args)
    assert len(jg) == len(tg) == 5
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-3 * np.abs(a).max()
        assert np.abs(a).max() > 0


def test_json_line_has_bench_keys(jbench, monkeypatch, capsys):
    """bench.py's five keys and metric names, plus ``device_ms`` (null on
    the CPU, where no device time is taken)."""
    mod, _ = jbench
    monkeypatch.setattr(sys, "argv", ["bench.py", "--mode", "2d"])
    mod.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = tb.run("2d", 1, device="cpu", iters=1, reps=1, **SMALL)
    assert set(line) == set(jline) | {"device_ms"}
    assert line["metric"] == jline["metric"] and line["unit"] == jline["unit"]
    assert line["baseline"] == jline["baseline"]
    assert tb.BASELINE_MPIX_S == mod.BASELINE_MPIX_S
    assert (tb.H, tb.W, tb.N) == (512, 576, 16000)
    assert line["device_ms"] is None
    assert line["value"] > 0 and line["vs_baseline"] > 0
