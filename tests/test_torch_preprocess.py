"""The port's preprocessing (``pose_splatter_torch/preprocess``,
``tracking.py``, ``ops/carving.py::get_volume``) against the JAX package's.

- The numpy copies (tracking, AAPCA, ``find_div_n_subarray``,
  ``suggest_volume_idx``) bit for bit.
- ``get_volume`` within 1e-6 (one frame and a batch of frames).
- The frame-batched carves ``_carve_moments_batch`` and
  ``_occupancy_batch`` at grids 16 and 24, 3 and 5 observed views, shared
  and per-frame K: the occupancy exactly, the moments at rtol 1e-5 (their
  float32 sums over the grid reduce in another order; a mean near 0 is
  held within 1e-5 of the grid's largest coordinate, a covariance within
  1e-5 of its largest entry).
- ``calculate_center_rotation`` and ``calculate_volume_sum`` on a
  synthetic project (mask videos written with ``cv2``, a camera ``.h5``),
  with and without the adaptive camera: the written angles within 1e-5,
  centres and covariances at rtol 1e-5, and the volume sum exactly, both
  packages carving from the same ``center_rotation.npz`` (the JAX one's).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu import tracking as jtracking
from pose_splatter_tpu.ops import carving as jcarv
from pose_splatter_tpu.preprocess import apca as japca
from pose_splatter_tpu.preprocess import center_rotation as jcr
from pose_splatter_tpu.preprocess import crop_indices as jci
from pose_splatter_torch import tracking as ttracking
from pose_splatter_torch.ops import carving as tcarv
from pose_splatter_torch.preprocess import apca as tapca
from pose_splatter_torch.preprocess import center_rotation as tcr
from pose_splatter_torch.preprocess import crop_indices as tci
from pose_splatter_torch.utils.cameras import (
    camera_extrinsic_spherical,
    get_cam_params,
)
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

torch.set_num_threads(1)

AXES = (0.12, 0.08, 0.07)  # the synthetic ellipsoid's semi-axes


# ----------------------------------------------------------------------------
# The numpy copies.
# ----------------------------------------------------------------------------

def _trajectory(T, seed):
    rng = np.random.default_rng(seed)
    means = np.cumsum(rng.normal(0, 0.01, (T, 3)), axis=0)
    A = rng.normal(size=(T, 3, 3))
    covs = A @ A.transpose(0, 2, 1) + np.diag([2.0, 0.5, 0.2])
    return means, covs


@pytest.mark.parametrize("T", [1, 2, 50])
def test_tracking_bit_equal(T):
    means, covs = _trajectory(T, seed=T)
    for name in ("principal_axes", "transport_matrices"):
        if name == "transport_matrices" and T < 2:
            continue
        np.testing.assert_array_equal(getattr(jtracking, name)(covs),
                                      getattr(ttracking, name)(covs))
    axes = ttracking.track_principal_axes(means, covs)
    np.testing.assert_array_equal(jtracking.track_principal_axes(means, covs), axes)
    np.testing.assert_array_equal(jtracking.axes_to_yaw_angles(axes),
                                  ttracking.axes_to_yaw_angles(axes))
    if T >= 2:
        x = np.ones(3)
        np.testing.assert_array_equal(
            jtracking.optimal_transport_map(means[0], covs[0], means[1], covs[1], x),
            ttracking.optimal_transport_map(means[0], covs[0], means[1], covs[1], x))


@pytest.mark.parametrize("mu", [0.0, 1e2])
def test_aapca_bit_equal(mu):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 12))
    Y = np.stack([np.cos(X[:, 0]), np.sin(X[:, 0])], 1)
    jm = japca.AAPCA(4, mu=mu, pow_iter=20, random_state=42)
    tm = tapca.AAPCA(4, mu=mu, pow_iter=20, random_state=42)
    np.testing.assert_array_equal(jm.fit_transform(X, Y), tm.fit_transform(X, Y))
    for a, b in zip(jm.reconstruct(X, Y), tm.reconstruct(X, Y)):
        np.testing.assert_array_equal(a, b)


def test_crop_suggestion_bit_equal():
    rng = np.random.default_rng(4)
    for n in (16, 8):
        for _ in range(200):
            arr = np.zeros(64)
            lo, hi = sorted(rng.integers(0, 65, 2))
            arr[lo:hi] = rng.integers(0, 5, hi - lo)
            thresh = int(rng.integers(1, 4))
            assert (tci.find_div_n_subarray(arr, thresh, n)
                    == jci.find_div_n_subarray(arr, thresh, n))
    vol = rng.integers(0, 40, (32, 32, 32)) * (rng.random((32, 32, 32)) < 0.2)
    assert tci.suggest_volume_idx(vol) == jci.suggest_volume_idx(vol)


# ----------------------------------------------------------------------------
# The device carves, on in-memory frames.
# ----------------------------------------------------------------------------

def _scene(n_obs, grid_size, B, seed):
    W, H = 64, 48
    Ks, Es = ring_cameras(n_obs, W, H, focal=110.0, radius=1.0)
    frames = synthetic_frames(Ks, Es, H, W, np.zeros(3), AXES, B, seed=seed)
    grid = create_3d_grid(0.4, grid_size)
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.01, (B, 3)).astype(np.float32)
    # Per-frame intrinsics: principal points moved by up to 2 px.
    Ks_b = np.repeat(Ks[None], B, 0)
    Ks_b[:, :, :2, 2] += rng.uniform(-2, 2, (B, n_obs, 2)).astype(np.float32)
    return frames, Ks, Ks_b, Es, grid, centers


def test_get_volume_matches_jax():
    frames, Ks, Ks_b, Es, grid, centers = _scene(3, 16, 2, seed=0)
    imgs = np.concatenate([frames["img"], frames["mask"][..., None]], -1)
    g = grid[None] + centers[:, None, None, None, :]
    got = tcarv.get_volume(torch.from_numpy(imgs), torch.from_numpy(Ks_b),
                           torch.from_numpy(Es), torch.from_numpy(g)).numpy()
    assert got.shape == (2, 4, 16, 16, 16)
    for b in range(2):
        ref = jcarv.get_volume(jnp.asarray(imgs[b]), jnp.asarray(Ks_b[b]),
                               jnp.asarray(Es), jnp.asarray(g[b]))
        np.testing.assert_allclose(got[b], np.asarray(ref), rtol=0, atol=1e-6)
        one = tcarv.get_volume(torch.from_numpy(imgs[b]), torch.from_numpy(Ks_b[b]),
                               torch.from_numpy(Es), torch.from_numpy(g[b]))
        np.testing.assert_array_equal(one.numpy(), got[b])
    assert 0 < got[:, 3].mean() < 1  # the mask channel holds the object


CARVES = [(n, g, k) for n in (3, 5) for g in (16, 24) for k in ("shared", "per_frame")]


@pytest.mark.parametrize("n_obs,grid_size,K_mode", CARVES)
def test_carve_moments_batch_matches_jax(n_obs, grid_size, K_mode):
    B = 3
    frames, Ks, Ks_b, Es, grid, centers = _scene(n_obs, grid_size, B, seed=n_obs)
    K = Ks if K_mode == "shared" else Ks_b
    thresh = (n_obs - 1.0) / n_obs
    jm, jc = jcr._carve_moments_batch(
        jnp.asarray(frames["mask"]), jnp.asarray(centers), jnp.asarray(grid),
        jnp.asarray(K), jnp.asarray(Es), carve_threshold=thresh)
    tm, tc = tcr._carve_moments_batch(
        torch.from_numpy(frames["mask"]), torch.from_numpy(centers),
        torch.from_numpy(grid), torch.from_numpy(K), torch.from_numpy(Es),
        carve_threshold=thresh)
    assert tm.shape == (B, 3) and tc.shape == (B, 3, 3)
    # The means cancel to a few mm from coordinates of up to 0.2: their
    # rounding is relative to the coordinates' scale.
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5 * float(np.abs(grid).max()))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jc).max()))
    assert float(np.abs(jc).max()) > 0  # something was carved


@pytest.mark.parametrize("n_obs,grid_size,K_mode", CARVES)
def test_occupancy_batch_matches_jax(n_obs, grid_size, K_mode):
    B = 4
    frames, Ks, Ks_b, Es, grid, centers = _scene(n_obs, grid_size, B, seed=10 + n_obs)
    K = Ks if K_mode == "shared" else Ks_b
    angles = np.random.default_rng(grid_size).uniform(-3, 3, B).astype(np.float32)
    for thresh in ((n_obs - 1.0) / n_obs, 1.0):
        ref = jci._occupancy_batch(
            jnp.asarray(frames["mask"]), jnp.asarray(centers), jnp.asarray(angles),
            jnp.asarray(grid), jnp.asarray(K), jnp.asarray(Es),
            carve_threshold=thresh)
        got = tci._occupancy_batch(
            torch.from_numpy(frames["mask"]), torch.from_numpy(centers),
            torch.from_numpy(angles), torch.from_numpy(grid), torch.from_numpy(K),
            torch.from_numpy(Es), carve_threshold=thresh)
        assert got.dtype == torch.int32 and got.shape == (grid_size,) * 3
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert int(got.max()) >= 1


# ----------------------------------------------------------------------------
# A synthetic project: mask and RGB videos, a camera file, a config.
# ----------------------------------------------------------------------------

VIDEO_W, VIDEO_H = 64, 48


def _write_video(fn, frames_bgr):
    """Lossless (FFV1) video of uint8 BGR frames [T, H, W, 3]."""
    import cv2

    h, w = frames_bgr.shape[1:3]
    writer = cv2.VideoWriter(fn, cv2.VideoWriter_fourcc(*"FFV1"), 30, (w, h), True)
    for f in frames_bgr:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def _look_at_point(E):
    """The point nearest every camera's optical axis (least squares)."""
    A, b = np.zeros((3, 3)), np.zeros(3)
    for e in E:
        R, t = e[:3, :3], e[:3, 3]
        c, d = -R.T @ t, R[2]
        P = np.eye(3) - np.outer(d, d)
        A += P
        b += P @ c
    return np.linalg.solve(A, b)


def make_video_project(root, n_cams=4, holdout=(2,), T=12, seed=0,
                       adaptive=False, **overrides):
    """Videos of a textured ellipsoid seen by ``n_cams`` ring cameras, the
    cameras' ``.h5`` and up-direction file, and a 3D config at grid 16.
    Returns (data_dir, a function(project_name) → config path that makes a
    project directory with its own copy of the camera files)."""
    import h5py

    data = root / "data"
    data.mkdir()
    # Cameras on half a ring (a full ring's mean y-axis, the adaptive
    # camera's up direction, is 0).
    Ks, _ = ring_cameras(n_cams, VIDEO_W, VIDEO_H, focal=110.0, radius=1.0)
    Es = np.stack([camera_extrinsic_spherical(1.0, np.pi / 3, phi)
                   for phi in np.linspace(0.3, 2.7, n_cams)])
    cam_src = str(data / "camera_params.h5")
    with h5py.File(cam_src, "w") as f:
        grp = f.create_group("camera_parameters")
        grp.create_dataset("intrinsic", data=Ks.astype(np.float64))
        grp.create_dataset("rotation", data=Es[:, :3, :3].astype(np.float64))
        grp.create_dataset("translation", data=Es[:, :3, 3].astype(np.float64))
    up_src = str(data / "vertical_lines.npz")
    np.savez(up_src, up=np.array([0.0, 0.0, -1.0]))
    # Frames seen by the cameras as the pipeline orients them.
    intr, extr, _ = get_cam_params(cam_src, up_fn=up_src,
                                   load_up_direction=not adaptive)
    fr = synthetic_frames(intr.astype(np.float32), extr.astype(np.float32),
                          VIDEO_H, VIDEO_W, _look_at_point(extr), AXES, T,
                          seed=seed)
    for c in range(n_cams):
        m = (fr["mask"][:, c] * 255).astype(np.uint8)
        _write_video(str(data / f"mask_{c}.avi"), np.repeat(m[..., None], 3, -1))
        rgb = np.round(fr["img"][:, c] * 255).astype(np.uint8)
        _write_video(str(data / f"rgb_{c}.avi"), rgb[..., ::-1])

    cfg = {
        "data_directory": str(data),
        "mask_video_fns": [f"mask_{c}.avi" for c in range(n_cams)],
        "video_fns": [f"rgb_{c}.avi" for c in range(n_cams)],
        "holdout_views": list(holdout),
        "image_directory": "images",
        "render_directory": "renders",
        "image_compression_level": 2,
        "camera_fn": "camera_params.h5",
        "vertical_lines_fn": "vertical_lines.npz",
        "center_rotation_fn": "center_rotation.npz",
        "volume_sum_fn": "volume_sum.npy",
        "model_fn": "checkpoint.pt",
        "feature_fn": "features.npy",
        "embedding_fn": "embedding.npy",
        "image_width": VIDEO_W,
        "image_height": VIDEO_H,
        "image_downsample": 1,
        "adaptive_camera": adaptive,
        "ell": 0.4,
        "ell_tracking": 0.4,
        "grid_size": 16,
        "frame_jump": 1,
        "volume_idx": [[0, 16], [0, 16], [0, 16]],
        "gaussian_mode": "3d",
        "min_n": 16,
        "max_n": 256,
        "num_unets": 2,
        "base_filters": 4,
    }
    cfg.update(overrides)

    def project(name):
        proj = root / name
        proj.mkdir()
        shutil.copy(cam_src, proj / "camera_params.h5")
        shutil.copy(up_src, proj / "vertical_lines.npz")
        path = proj / "config.json"
        path.write_text(json.dumps(dict(cfg, project_directory=str(proj))))
        return str(path)

    return data, project


@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "adaptive"])
def project_runs(request, tmp_path_factory):
    """Both packages' center/rotation and volume sum on one project."""
    pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from pose_splatter_tpu.config import Config as JConfig
    from pose_splatter_torch.config import Config as TConfig

    root = tmp_path_factory.mktemp("video_project")
    _, project = make_video_project(root, adaptive=request.param)
    jcfg, tcfg = JConfig(project("jax")), TConfig(project("torch"))
    out = dict(jax_cr=jcr.calculate_center_rotation(jcfg, device_batch=5,
                                                     progress=False),
               torch_cr=tcr.calculate_center_rotation(tcfg, device_batch=5,
                                                      progress=False,
                                                      device="cpu"))
    out["jax_vs"] = jci.calculate_volume_sum(jcfg, device_batch=3)
    shutil.copy(jcfg.center_rotation_fn, tcfg.center_rotation_fn)
    out["torch_vs"] = tci.calculate_volume_sum(tcfg, device_batch=3, device="cpu")
    out["configs"] = (jcfg, tcfg)
    return out


def test_center_rotation_files_match_jax(project_runs):
    jcfg, tcfg = project_runs["configs"]
    ref = np.load(jcfg.center_rotation_fn)
    got = dict(zip(("centers", "angles", "covs"), project_runs["torch_cr"]))
    assert got["centers"].shape == (12, 3) and got["covs"].shape == (12, 3, 3)
    for k in ("centers", "covs"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref[k]).max()))
    np.testing.assert_allclose(got["angles"], ref["angles"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(project_runs["jax_cr"][1], ref["angles"])


def test_volume_sum_matches_jax_exactly(project_runs):
    jcfg, tcfg = project_runs["configs"]
    ref = np.load(jcfg.volume_sum_fn)
    got = np.load(tcfg.volume_sum_fn)
    assert got.dtype == ref.dtype == np.int64 and got.shape == (16, 16, 16)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(project_runs["torch_vs"], got)
    assert int(got.max()) == 4  # every frame carved the object's core
    assert tci.suggest_volume_idx(got) == jci.suggest_volume_idx(ref)


def test_entry_points_take_the_card_by_default(tmp_path):
    """Without ``device``, the carves ask for the card (and raise without
    one, before any video is read)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pose_splatter_torch.config import Config

    cfg = Config({"project_directory": str(tmp_path), "holdout_views": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcr.calculate_center_rotation(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tci.calculate_volume_sum(cfg)
