"""The port's whole 2D view-anchored eval forward, eval step, losses and
metrics against the JAX package, at a small size.

Both models get the same weights (seeded numpy values moved through the
bridge) and the same synthetic frames (an ellipsoid seen by 5 cameras,
from ``pose_splatter_torch.utils.synthetic``). The JAX model renders
through its Pallas kernel in interpret mode, the port through the
compositor's plain version (CPU tensors).
"""

import os
import subprocess
import sys
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
from pose_splatter_tpu.train import evaluate as jeval
from pose_splatter_tpu.train.loop import TrainState
from pose_splatter_tpu.train.loop import make_eval_step as jmake_eval_step
from pose_splatter_tpu.train.losses import total_loss as jtotal_loss
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.ops.ssim import psnr as tpsnr
from pose_splatter_torch.ops.ssim import ssim as tssim
from pose_splatter_torch.train import evaluate as teval
from pose_splatter_torch.train.loop import make_eval_step as tmake_eval_step
from pose_splatter_torch.train.losses import total_loss as ttotal_loss
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.device import resolve_device
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
C, H, W = 5, 48, 64
HOLDOUT = [1]
KW = dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
          volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="2d", gaussian_config={"view_anchored": True},
          holdout_views=HOLDOUT, volume_fill_color=0.38)


@pytest.fixture(scope="module")
def setup():
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(2.0), np.float32)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    tm.net.load_state_dict(variables_from_flax(variables))
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=2, seed=0)
    return jm, variables, tm, frames


def test_eval_forward_matches(setup):
    jm, variables, tm, frames = setup
    obs = tm.observed_views
    mask, img = frames["mask"][0, obs], frames["img"][0, obs]
    p_3d, angle = frames["p_3d"][0], frames["angle"][0]
    with pltpu.force_tpu_interpret_mode():
        ref = jm.forward(jax.tree.map(jnp.asarray, variables), jnp.asarray(mask),
                         jnp.asarray(img), jnp.asarray(p_3d), jnp.float32(angle),
                         jnp.arange(C), train=False, return_overflow=True)
    rgb, alpha, overflow = tm(mask, img, p_3d, angle, torch.arange(C),
                              return_overflow=True)
    assert rgb.shape == (C, H, W, 3) and alpha.shape == (C, H, W)
    # Carve and selection are exact; U-Net, head and projection differ by
    # float32 summation order (~1e-6), which the compositor keeps small.
    np.testing.assert_allclose(np.asarray(ref[0]), rgb.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref[1]), alpha.numpy(), atol=1e-4)
    assert int(ref[3]) == int(overflow)
    assert float(alpha.max()) > 0.5  # the Gaussians are visible
    # The selection is full: enough occupied voxels for max_n Gaussians.
    vol = tm.carve(mask, img, p_3d, angle)
    g = tm.gaussians_from_volume(
        tm.net.process_volume(vol.permute(1, 2, 3, 0)[None]))
    assert int(g["valid"].sum()) == KW["max_n"]


def test_stage_marks_record_the_forward(setup):
    """A recorded forward reports every stage in order, hands back the
    instance arrays it binned, and renders exactly what an unrecorded one
    does; outside a recording the marks do nothing."""
    _, _, tm, frames = setup
    obs = tm.observed_views
    inputs = (frames["mask"][0, obs], frames["img"][0, obs],
              frames["p_3d"][0], frames["angle"][0], torch.arange(C))
    plain = tm(*inputs)
    with stages.record("cpu") as rec:
        recorded = tm(*inputs)
        with pytest.raises(RuntimeError, match="already active"):
            with stages.record("cpu"):
                pass
    assert list(rec.spans) == ["carve", "unets", "select_head", "binning",
                               "kernel", "untile"]
    assert all(x >= 0 for v in rec.spans.values() for x in v)
    assert all(len(v) == 1 for v in rec.spans.values())
    (b,) = rec.values["binning"]
    assert b.counts.numel() == C * b.n_ty * b.n_tx
    assert int(rec.values["select_head"][0]["valid"].sum()) == KW["max_n"]
    assert torch.equal(plain[0], recorded[0])
    assert torch.equal(plain[1], recorded[1])
    assert stages._active is None


@pytest.mark.parametrize("anchored", [False, True])
def test_render_matches(setup, anchored):
    """``render`` of given Gaussians: with anchors each view projects its own
    means; without, one image is broadcast to every requested view."""
    jm, _, tm, _ = setup
    rng = np.random.default_rng(11)
    n = 96
    g = dict(
        means2d=(rng.normal(0, 1.5, (n, 2)) if anchored else
                 rng.uniform(0, 1, (n, 2)) * [W, H]).astype(np.float32),
        log_scales2d=rng.uniform(0.0, 1.2, (n, 2)).astype(np.float32),
        rotation=rng.normal(0, 1, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        logit_opacities=rng.normal(0, 1, n).astype(np.float32),
        valid=rng.uniform(size=n) < 0.9,
    )
    if anchored:
        voxels = tm.grid.reshape(-1, 3).numpy()
        g["anchor_means"] = voxels[rng.choice(len(voxels), n, replace=False)]
    views = np.array([0, 3], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.render({k: jnp.asarray(v) for k, v in g.items()},
                        jnp.asarray(views), return_overflow=True)
    rgb, alpha, overflow = tm.render(
        {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}, views)
    assert rgb.shape == (2, H, W, 3)
    np.testing.assert_allclose(np.asarray(ref[0]), rgb.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref[1]), alpha.numpy(), atol=1e-5)
    assert int(ref[2]) == int(overflow)


def test_eval_step_matches(setup):
    jm, variables, tm, frames = setup
    obs = tm.observed_views
    batch = dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                 p_3d=frames["p_3d"], angle=frames["angle"],
                 view_idx=np.array([obs[0], obs[2]], np.int32),
                 obs_idx=np.array([0, 2], np.int32))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, variables["params"]),
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=None)
    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_m = jmake_eval_step(jm, 0.5, 0.1)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = tmake_eval_step(tm, 0.5, 0.1)(batch)
    # Loss terms are sums over the image of the rgb/alpha above.
    np.testing.assert_allclose(float(ref_loss), float(loss), rtol=1e-4)
    for k in ("iou", "ssim", "img", "total", "overflow"):
        np.testing.assert_allclose(float(ref_m[k]), float(m[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_render_images_h5_and_in_memory(setup, tmp_path):
    pytest.importorskip("h5py")
    import h5py

    _, _, tm, frames = setup
    data = FrameSet(frames, tm.observed_views)
    mem = teval.render_images_in_memory(tm, data)
    assert mem.shape == (2, C, H, W, 4) and mem.dtype == np.uint8
    fn = teval.render_images(tm, data, total_num_frames=3,
                             render_fn=str(tmp_path / "r.h5"), progress=False)
    with h5py.File(fn, "r") as f:
        stored = f["images"][:]
    assert stored.shape == (3, C, H, W, 4)
    np.testing.assert_array_equal(stored[1:], mem)  # test split at the end
    assert (stored[0] == 0).all()


def test_losses_ssim_and_metrics_match():
    rng = np.random.default_rng(7)
    pred = rng.uniform(0, 1, (2, C, 24, 28, 3)).astype(np.float32)
    gt = np.where(rng.uniform(size=(2, C, 24, 28, 1)) < 0.3, 1.0,
                  rng.uniform(0, 1, (2, C, 24, 28, 3))).astype(np.float32)
    alpha = rng.uniform(0, 1, (2, C, 24, 28)).astype(np.float32)
    # ssim / psnr in float32: filters summed in another order.
    np.testing.assert_allclose(float(jssim(jnp.asarray(pred[0]), jnp.asarray(gt[0]))),
                               float(tssim(torch.from_numpy(pred[0]),
                                           torch.from_numpy(gt[0]))), atol=1e-6)
    np.testing.assert_allclose(float(jpsnr(jnp.asarray(pred), jnp.asarray(gt))),
                               float(tpsnr(torch.from_numpy(pred),
                                           torch.from_numpy(gt))), rtol=1e-6)
    mask = (gt[0, 0, ..., 0] < 1.0).astype(np.float32)
    ref, ref_terms = jtotal_loss(jnp.asarray(pred[0, 0]), jnp.asarray(alpha[0, 0]),
                                 jnp.asarray(gt[0, 0]), jnp.asarray(mask), 0.5, 0.1)
    got, terms = ttotal_loss(torch.from_numpy(pred[0, 0]),
                             torch.from_numpy(alpha[0, 0]),
                             torch.from_numpy(gt[0, 0]), torch.from_numpy(mask),
                             0.5, 0.1)
    np.testing.assert_allclose(float(ref), float(got), rtol=1e-5)
    for k in ref_terms:
        np.testing.assert_allclose(float(ref_terms[k]), float(terms[k]),
                                   rtol=1e-5, atol=1e-7)
    ref_m = jeval._batch_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                 jnp.asarray(alpha))
    got_m = teval._batch_metrics(torch.from_numpy(gt), torch.from_numpy(pred),
                                 torch.from_numpy(alpha))
    # Per-camera sums; SSIM's variance estimates (E[x²] − μ²) lose a few
    # float32 ulps to the filter's summation order.
    for k in ref_m:
        np.testing.assert_allclose(np.asarray(ref_m[k]), got_m[k].numpy(),
                                   rtol=1e-5, atol=2e-6, err_msg=k)


def test_entry_point_raises_without_cuda(monkeypatch):
    """An entry point asked for the card (the default) never runs on the
    CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(Ks, Es, W, H, **KW)


def test_cuda_entry_turns_tf32_off(monkeypatch):
    """Trap: cuDNN runs float32 conv3d in TF32 by default. An entry point
    that takes the card turns TF32 off for convolutions and matmuls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cuda") == torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_cuda_entry_autotunes_cudnn(monkeypatch):
    """Trap: without autotuning cuDNN takes its heuristic's first algorithm,
    a direct kernel for the final U-Net's float32 conv3d weight gradients.
    An entry point that takes the card turns cuDNN's autotuning on and
    leaves TF32 off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cuda") == torch.device("cuda")
    assert torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_ssim_filters_without_tf32(monkeypatch):
    """SSIM's E[x²] − μ² variance estimates need true float32: its filter
    runs with TF32 off even where the caller allowed it, and restores the
    caller's setting afterwards."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    x = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(0))
    tssim(x, x)
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32


def test_port_imports_without_jax():
    """The package imports with jax and flax absent, and never loads the
    JAX package; also with the optional packages that a machine may lack
    (cv2, h5py, sklearn, joblib, zarr, matplotlib, PIL) absent, since every
    module imports them inside the functions that use them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'cv2', 'h5py', 'sklearn', 'joblib', 'zarr',\n"
        "          'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import pose_splatter_torch\n"
        "for m in pkgutil.walk_packages(pose_splatter_torch.__path__, "
        "'pose_splatter_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.startswith('pose_splatter_tpu') for k in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
