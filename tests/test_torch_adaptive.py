"""The adaptive camera in the port against the JAX package, at a small
size: the copied camera helpers, the forward in 3D and in anchored 2D, the
loader's ``K_mask`` / ``seed_3d``, ``render_images_in_memory`` against the
JAX ``render_images``, and ``train_from_config`` with ``adaptive_camera``.

Both models get the same weights (seeded numpy values moved through the
bridge) and the same synthetic frames; each side takes its frame's
``temp_K`` and seed from its own host hook (``make_adaptive_fn``), which
must agree bit for bit. The JAX model renders through its Pallas kernels
in interpret mode, the port through the compositors' plain versions.

Conic mode gates each contribution (the 1/255 skip, the 0.999 clamp,
T·(1 − a) >= 1e-4), and the two sides round differently upstream of the
gates (ROADMAP C.14). The seeded scenes here hold no pixel-Gaussian pair
within that rounding of a gate, so images agree within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.data.dataset import FrameDataset as JDataset
from pose_splatter_tpu.data.dataset import FrameLoader as JLoader
from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.train import evaluate as jeval
from pose_splatter_tpu.utils import cameras as jcams
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.data.dataset import FrameDataset, FrameLoader
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train import evaluate as teval
from pose_splatter_torch.train.trainer import make_adaptive_fn, train_from_config
from pose_splatter_torch.utils import cameras as tcams
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)
from test_torch_model_3d import AXES as AXES3, KW as KW3, C as C3, H as H3, W as W3
from test_torch_train_loop import (
    KW as KW2, C as C2, H as H2, W as W2, _config, _write_h5,
)
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)


def test_camera_helpers_equal_jax():
    """Each copied helper on seeded inputs, bit for bit."""
    rng = np.random.default_rng(3)
    Ps = rng.normal(size=(4, 3, 4))
    x1, x2 = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    pts = rng.uniform(0, 50, (4, 2))
    w = rng.uniform(0, 1, (3, 17))
    masks = np.zeros((4, 24, 32), np.float32)
    for i in range(4):
        masks[i, 5 + i:15 + i, 8:20 + 2 * i] = 1.0
    Ks = np.array([[[40.0, 0, 16.5], [0, 41.0, 12.2], [0, 0, 1]]] * 4)
    Es = np.stack([tcams.camera_extrinsic_spherical(1.5, 1.0, 1.5 * i)
                   for i in range(4)])
    points = [pts[0], None, pts[2], pts[3]]
    pairs = [
        (tcams.triangulate_points(Ps[0], Ps[1], x1, x2),
         jcams.triangulate_points(Ps[0], Ps[1], x1, x2)),
        (tcams._pairwise_triangulate(pts, Ps), jcams._pairwise_triangulate(pts, Ps)),
        (tcams.weighted_median(w[0]), jcams.weighted_median(w[0])),
        (tcams.batch_weighted_median(w), jcams.batch_weighted_median(w)),
        (tcams.get_rough_center_3d(masks, Ps), jcams.get_rough_center_3d(masks, Ps)),
        (tcams._mask_medoids(masks), jcams._mask_medoids(masks)),
    ]
    pairs += list(zip(tcams.triangulate_and_reproject(points, Ps),
                      jcams.triangulate_and_reproject(points, Ps)))
    for dtype in (np.float64, np.float32):
        pairs += list(zip(
            tcams.adjust_principal_points_to_seed(masks, Ks.astype(dtype), Es.astype(dtype)),
            jcams.adjust_principal_points_to_seed(masks, Ks.astype(dtype), Es.astype(dtype))))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(i))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    with pytest.raises(ValueError, match="empty"):
        tcams._mask_medoids(np.zeros((1, 4, 4)))


def _models(mode):
    """Both models and two frames of an ellipsoid placed off the crop's
    centre, so that its mask medoids leave the principal points (the
    adaptive camera then moves them)."""
    if mode == "3d":
        C, H, W, kw, scale = C3, H3, W3, KW3, np.log(0.03)
        Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
        axes, off = AXES3, np.array([0.03, -0.02, 0.015])
    else:
        C, H, W, kw, scale = C2, H2, W2, KW2, np.log(2.0)
        Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
        axes, off = (0.05, 0.035, 0.03), np.array([0.015, -0.01, 0.008])
    grid = create_3d_grid(kw["ell"], kw["grid_size"], kw["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0) + off,
                              axes, n_frames=2, seed=0)
    crop = (1, 16, 16, 16, 4)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", adaptive_camera=True, **kw)
    variables = random_variables(jm.net, jnp.zeros(crop), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), scale, np.float32)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu",
                adaptive_camera=True, **kw)
    tm.net.load_state_dict(variables_from_flax(variables))
    return jm, variables, tm, frames


@pytest.fixture(scope="module", params=["3d", "2d"])
def adaptive(request):
    return (request.param,) + _models(request.param)


def test_adaptive_forward_matches_jax(adaptive):
    """One frame through both adaptive forwards, every view: the carve at
    the seed through ``temp_K``, the pose transform at ``p_3d``, the render
    through ``temp_K`` (3D projection, anchored 2D anchors)."""
    mode, jm, variables, tm, frames = adaptive
    obs = tm.observed_views
    mask, img = frames["mask"][0, obs], frames["img"][0, obs]
    p_3d, angle = frames["p_3d"][0], frames["angle"][0]
    jK, jseed = jm.make_adaptive_fn()(mask)
    tK, tseed = tm.make_adaptive_fn()(mask)
    np.testing.assert_array_equal(jK, tK)
    np.testing.assert_array_equal(jseed, tseed)
    assert np.abs(tK - tm.Ks_obs.numpy()).max() > 0.01
    C = tm.num_cameras
    with pltpu.force_tpu_interpret_mode():
        ref = jm.forward(jax.tree.map(jnp.asarray, variables), jnp.asarray(mask),
                         jnp.asarray(img), jnp.asarray(p_3d), jnp.float32(angle),
                         jnp.arange(C), train=False,
                         K_mask=jnp.asarray(tK, jnp.float32),
                         carve_center=jnp.asarray(tseed, jnp.float32),
                         return_overflow=True)
    Ks_before = tm.Ks.clone()
    rgb, alpha, overflow = tm(mask, img, p_3d, angle, torch.arange(C),
                              return_overflow=True, K_mask=tK.astype(np.float32),
                              carve_center=tseed.astype(np.float32))
    assert torch.equal(tm.Ks, Ks_before)  # temp_K went into a copy
    np.testing.assert_allclose(np.asarray(ref[0]), rgb.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref[1]), alpha.numpy(), rtol=0, atol=1e-4)
    assert int(ref[3]) == int(overflow)
    assert float(alpha.max()) > 0.5
    # The adaptive frame renders otherwise than the plain forward.
    rgb0, _ = tm(mask, img, p_3d, angle, torch.arange(C))
    assert float((rgb0 - rgb).abs().max()) > 1e-3


def test_render_images_in_memory_matches_jax(adaptive, tmp_path):
    """``render_images_in_memory`` takes each frame's ``temp_K`` and seed,
    as the JAX ``render_images`` does: the uint8 renders of both frames and
    every view agree within one level. Each side truncates its own float
    image, and the two agree within 1e-4 = 0.0255 of a level, which moves
    the truncation of at most about 2.6 % of the values."""
    h5py = pytest.importorskip("h5py")
    mode, jm, variables, tm, frames = adaptive
    data = FrameSet(frames, tm.observed_views)
    mem = teval.render_images_in_memory(tm, data)
    with pltpu.force_tpu_interpret_mode():
        fn = jeval.render_images(jm, jax.tree.map(jnp.asarray, variables), data,
                                 total_num_frames=2,
                                 render_fn=str(tmp_path / "r.h5"),
                                 progress=False)
    with h5py.File(fn, "r") as f:
        ref = f["images"][:]
    assert mem.shape == ref.shape
    diff = np.abs(mem.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.974


def test_frame_loader_adaptive_batches_equal_jax(tmp_path):
    """With ``adaptive_fn`` each batch gains ``K_mask`` [B,C',3,3] and
    ``seed_3d`` [B,3], equal to the JAX loader's (each side's own model
    hook on the same cameras)."""
    img_fn, cr_fn = _write_h5(tmp_path, T=6, C_=3, H_=16, W_=20)
    Ks, Es = ring_cameras(3, 20, 16, focal=30.0, radius=0.6)
    kw = dict(ell=0.3, grid_size=16, volume_idx=[[0, 16]] * 3,
              holdout_views=[1], adaptive_camera=True)
    jfn = JModel(Ks, Es, 20, 16, **kw).make_adaptive_fn()
    tfn = make_adaptive_fn(TModel(Ks, Es, 20, 16, device="cpu", **kw))
    dkw = dict(holdout_views=[1], split="all_volumes", seed=4)
    lkw = dict(batch_size=2, shuffle=True, seed=5, prefetch=1, workers=2)
    ref = list(JLoader(JDataset(img_fn, cr_fn, 3, **dkw), adaptive_fn=jfn, **lkw))
    got = list(FrameLoader(FrameDataset(img_fn, cr_fn, 3, **dkw),
                           adaptive_fn=tfn, **lkw))
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b) and "K_mask" in b and "seed_3d" in b
        assert b["K_mask"].shape == (2, 2, 3, 3) and b["seed_3d"].shape == (2, 3)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            if k == "img":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_from_config_adaptive_two_epochs_and_resume(tmp_path, monkeypatch):
    """``adaptive_camera`` trains: both loaders call the model's hook on
    every frame, two epochs with validation, a checkpoint, and a resume."""
    Ks, Es = ring_cameras(C2, W2, H2, focal=150.0, radius=0.6)
    grid = create_3d_grid(KW2["ell"], KW2["grid_size"], KW2["volume_idx"])
    frames = synthetic_frames(Ks, Es, H2, W2, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=4, seed=0)
    obs = [0, 2, 3, 4]
    train = FrameSet({k: v[:3] for k, v in frames.items()}, obs)
    valid = FrameSet({k: v[3:] for k, v in frames.items()}, obs, split="valid")
    calls = []
    hook = TModel.make_adaptive_fn

    def counted(model):
        fn = hook(model)

        def wrapped(mask):
            assert isinstance(mask, np.ndarray) and mask.shape == (4, H2, W2)
            calls.append(1)
            return fn(mask)
        return wrapped

    monkeypatch.setattr(TModel, "make_adaptive_fn", counted)
    kw = dict(device="cpu", cameras=(Ks, Es), datasets=(train, valid),
              max_batches=2)
    config = _config(tmp_path, adaptive_camera=True)
    state, losses, vlosses = train_from_config(config, epochs=2, **kw)
    assert state.model.adaptive_camera and state.step == 4
    assert len(losses) == 2 and len(vlosses) == 2
    assert all(np.isfinite(x) for row in losses for x in row)
    assert len(calls) >= 4 + 2  # train frames and validation frames
    state2, losses2, _ = train_from_config(config, epochs=1, load=True, **kw)
    assert state2.step == 6 and len(losses2) == 3 and np.isfinite(losses2[-1]).all()
