"""The port's synthetic quality benchmark
(``pose_splatter_torch/scripts/synthetic_benchmark.py``) against the JAX
script (``scripts/synthetic_benchmark.py``, loaded from its file), on the
CPU at a small size: 3 cameras of 32×32, grid 16, 2 frames.

- The rig and the painter's-algorithm scene oracle equal the JAX script's
  bit for bit.
- With the same weights (seeded numpy values through the bridge) the
  port's held-out PSNR / SSIM / IoU and its per-camera rows equal what the
  JAX script's evaluation computes with the JAX model, rendered by its
  Pallas kernels in interpret mode.
- ``main()`` trains a few steps through the K-step call and prints a report
  with the JAX script's keys; the flags that are not ported raise.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.ops.ssim import psnr as jpsnr
from pose_splatter_tpu.ops.ssim import ssim as jssim
from pose_splatter_tpu.train.losses import iou_loss as jiou_loss
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.scripts import synthetic_benchmark as tsb
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
C, H, W, T, GRID = 3, 32, 32, 2, 16
HOLDOUT = C - 1
MODEL = dict(min_n=8, max_n=64, anchored=True)
TINY = ["--cameras", "3", "--width", "32", "--height", "32", "--grid", "16",
        "--frames", "2", "--min-n", "8", "--max-n", "64", "--mode", "2d",
        "--anchored", "--device", "cpu"]


@pytest.fixture(scope="module")
def jscript():
    """The JAX benchmark script, loaded from its file as it stands."""
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_benchmark", ROOT / "scripts" / "synthetic_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rig_and_scene_equal_the_jax_script(jscript):
    for a, b in zip(jscript.make_rig(C, H, W), tsb.make_rig(C, H, W)):
        np.testing.assert_array_equal(a, b)
    ref = jscript.make_scene(C, H, W, T=T, radii=(0.10, 0.05, 0.04))
    got = tsb.make_scene(C, H, W, T=T, radii=(0.10, 0.05, 0.04))
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[2] < 255).any()  # the animal is in view


def _jax_eval(jm, variables, masks, imgs, centers, angles, obs):
    """The JAX script's evaluation (``main``, after training): the held-out
    view of every frame, then every view with the per-camera metrics."""
    psnrs, ssims, ious = [], [], []
    cams = {v: dict(l1=[], iou=[], soft_iou=[], psnr=[], ssim=[])
            for v in range(C)}
    for t in range(T):
        args = (jnp.asarray(masks[t][obs]), jnp.asarray(imgs[t][obs]),
                jnp.asarray(centers[t]), jnp.asarray(angles[t]))
        rgb, alpha, _ = jm.forward(variables, *args, HOLDOUT, train=False)
        tmask = jnp.asarray(masks[t][HOLDOUT])
        target = jnp.asarray(imgs[t][HOLDOUT])
        psnrs.append(float(jpsnr(rgb[0], target)))
        ssims.append(float(jssim(rgb[0], target)))
        ious.append(float(1.0 - jiou_loss(
            jnp.where(alpha[0] > 0.5, 1.0, 0.0), tmask)))
        rgb, alpha, _ = jm.forward(variables, *args,
                                   jnp.arange(C, dtype=jnp.int32), train=False)
        for v in range(C):
            tgt, tm = jnp.asarray(imgs[t][v]), jnp.asarray(masks[t][v])
            hard = jnp.where(alpha[v] > 0.5, 1.0, 0.0)
            inter = jnp.sum(hard * tm)
            union = jnp.sum(jnp.maximum(hard, tm))
            msum = jnp.maximum(jnp.sum(tm), 1.0)
            cams[v]["l1"].append(float(jnp.sum(jnp.abs(tgt - rgb[v])) / msum))
            cams[v]["iou"].append(float(inter / jnp.maximum(union, 1.0)))
            cams[v]["soft_iou"].append(1.0 - float(jiou_loss(alpha[v], tm)))
            cams[v]["psnr"].append(float(jpsnr(rgb[v], tgt)))
            cams[v]["ssim"].append(float(jssim(rgb[v], tgt)))
    per_cam = {str(v): {k: float(np.mean(x)) for k, x in cams[v].items()}
               for v in range(C)}
    return psnrs, ssims, ious, per_cam


def test_evaluation_matches_the_jax_model(jscript):
    Ks, Es, frames, centers, angles = jscript.make_scene(C, H, W, T=T)
    imgs = frames.astype(np.float32) / 255.0
    masks = np.where(imgs[..., 0] == 1.0, 0.0, 1.0).astype(np.float32)
    obs = [i for i in range(C) if i != HOLDOUT]
    jm = JModel(Ks, Es, W, H, ell=0.35, grid_size=GRID,
                volume_idx=[[0, GRID]] * 3, holdout_views=[HOLDOUT],
                gaussian_mode="2d", gaussian_config={"view_anchored": True},
                render_mode="pallas", min_n=MODEL["min_n"],
                max_n=MODEL["max_n"])
    variables = random_variables(jm.net, jnp.zeros((1, GRID, GRID, GRID, 4)),
                                 seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(3.0), np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_eval(jm, jax.tree.map(jnp.asarray, variables), masks, imgs,
                        centers, angles, obs)
    model = tsb.build_model(C, H, W, GRID, "2d", holdout=HOLDOUT,
                            device="cpu", **MODEL)
    model.net.load_state_dict(variables_from_flax(variables))
    got = tsb.evaluate(model, masks, imgs, centers, angles, HOLDOUT, True)
    # Images agree within 1e-4 (test_torch_eval_slice); the metrics are
    # means of them: PSNR within 1e-3 dB, the rest within 1e-4.
    np.testing.assert_allclose(ref[0], got[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ref[1], got[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ref[2], got[2], rtol=0, atol=1e-4)
    for v in range(C):
        row_ref, row = ref[3][str(v)], got[3][str(v)]
        assert sorted(row_ref) == sorted(row)
        for k, x in row_ref.items():
            # The port's rows are rounded to 4 places, as the script's.
            tol = 1e-3 if k == "psnr" else 1e-4
            assert abs(x - row[k]) <= tol + 5e-5, (v, k, x, row[k])
    # Random weights: the Gaussians cover part of the animal on each view.
    assert min(r["soft_iou"] for r in got[3].values()) > 0.02


def _report_keys(path):
    """Keys the script writes into its ``report`` dict."""
    keys = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "report"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "report"):
            keys.add(node.slice.value)
    return keys


def test_main_prints_the_jax_scripts_report(capsys):
    report = tsb.main(TINY + ["--steps", "4", "--steps-per-call", "2",
                              "--per-camera"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    jkeys = _report_keys(ROOT / "scripts" / "synthetic_benchmark.py")
    memory = {"hbm_peak_bytes", "hbm_limit_bytes"}
    # Device memory is reported where the device keeps statistics: the
    # card here, the TPU there; neither on the CPU.
    assert memory <= jkeys and memory <= _report_keys(tsb.__file__)
    assert set(report) == jkeys - memory
    assert report["backend"] == "cpu" and report["steps"] == 4
    assert report["config"] == "32x32 grid16 2d-anchored C3"
    assert sorted(report["per_camera"]) == ["0", "1", "2"]
    assert set(report["per_camera"]["0"]) == {"l1", "iou", "soft_iou",
                                              "psnr", "ssim"}
    assert np.isfinite(report["holdout_psnr_db"])


@pytest.mark.parametrize("flag,attr,value", [
    (["--carve-cap", "256"], "carve_visibility_cap", 256),
    (["--remat-unets"], "remat", True)])
def test_flags_reach_the_model(flag, attr, value, monkeypatch, capsys):
    """``--carve-cap`` and ``--remat-unets`` (the JAX script's flags) build
    their model and train: a step runs and the report is finite."""
    built = []
    build = tsb.build_model

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(tsb, "build_model", spy)
    report = tsb.main(TINY + ["--steps", "1"] + flag)
    model = built[0]
    assert getattr(model.net if attr == "remat" else model, attr) == value
    assert report["steps"] == 1 and np.isfinite(report["holdout_psnr_db"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.main([a for a in TINY if a not in ("--device", "cpu")]
                 + ["--steps", "1"])
