"""The port's input-pipeline probe
(``pose_splatter_torch/scripts/dbg_input_pipeline.py``) against the JAX
script (``scripts/dbg_input_pipeline.py``, loaded from its file), on the
CPU with the scripts' size constants patched small (3 views of 48×32,
grid 32, crop 32×32×16).

- ``build_dataset`` writes the JAX function's ``images.h5`` and
  ``center_rotation.npz`` contents.
- ``main`` prints and returns the JAX script's keys plus ``decode``, with
  finite times, by the JAX rule for ``input_bound``.
- The port's ``FrameLoader`` over the probe's dataset yields the JAX
  loader's batches bit for bit (both decode natively where both libraries
  build; one ulp apart otherwise).
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_tpu.data import native as jnative
from pose_splatter_tpu.data.dataset import FrameDataset as JDataset
from pose_splatter_tpu.data.dataset import FrameLoader as JLoader
from pose_splatter_torch.data import native as tnative
from pose_splatter_torch.data.dataset import FrameDataset, FrameLoader
from pose_splatter_torch.scripts import dbg_input_pipeline as tip

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(C=3, H=32, W=48, GRID=32, CROP="0,32,0,32,0,16")


@pytest.fixture(scope="module")
def jip():
    spec = importlib.util.spec_from_file_location(
        "jax_dbg_input_pipeline", ROOT / "scripts" / "dbg_input_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(jip, monkeypatch):
    for mod in (jip, tip):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def test_build_dataset_equals_the_jax_function(jip, small, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = jip.build_dataset(str(tmp_path / "j"), 5)
    got = tip.build_dataset(str(tmp_path / "t"), 5)
    import h5py

    with h5py.File(ref[0], "r") as a, h5py.File(got[0], "r") as b:
        assert a["images"].chunks == b["images"].chunks
        np.testing.assert_array_equal(a["images"][:], b["images"][:])
        assert a["images"].shape == (5, 3, 32, 48, 3)
    za, zb = np.load(ref[1]), np.load(got[1])
    assert za.files == zb.files
    for k in za.files:
        assert za[k].dtype == zb[k].dtype
        np.testing.assert_array_equal(za[k], zb[k])


def _jax_report_keys(path):
    """The keywords of the ``dict(...)`` the JAX script reports."""
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and any(isinstance(t, ast.Name) and t.id == "report"
                        for t in node.targets)):
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no report in the JAX script")


def test_main_prints_the_jax_keys(small, monkeypatch, capsys):
    monkeypatch.setattr(tip, "STEP_REPS", 1)
    report = tip.main(["--frames", "6", "--steps", "2", "--workers", "2",
                       "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == report
    keys = _jax_report_keys(ROOT / "scripts" / "dbg_input_pipeline.py")
    assert set(report) == keys | {"decode"}
    assert report["config"] == "48x32 grid32 2d C3 crop(0,32,0,32,0,16)"
    assert report["workers"] == 2 and report["backend"] == "cpu"
    assert report["decode"] == tnative.route()
    times = [report[k] for k in ("data_ms_per_batch", "step_ms",
                                 "overlapped_ms")]
    assert np.isfinite(times).all() and min(times) > 0
    assert report["input_bound"] == (report["overlapped_ms"]
                                     > 1.15 * report["step_ms"])


def test_loader_batches_equal_the_jax_loaders(jip, small, tmp_path):
    img_fn, cr_fn = tip.build_dataset(str(tmp_path), 12)
    kw = dict(holdout_views=[2], split="train")
    lkw = dict(batch_size=1, shuffle=True, workers=4)
    ref = list(JLoader(JDataset(img_fn, cr_fn, 3, **kw), **lkw))
    got = list(FrameLoader(FrameDataset(img_fn, cr_fn, 3, **kw), **lkw))
    assert len(ref) == len(got) == 4
    both_native = jnative.available() and tnative.available()
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            if k == "img" and not both_native:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (got[0]["mask"] > 0).any() and (got[0]["mask"] == 0).any()
