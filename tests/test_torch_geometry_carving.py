"""Parity of the port's geometry, cameras and carving with the JAX package.

Same numpy inputs go through both; the JAX package is the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.ops import carving as jcarv
from pose_splatter_tpu.utils import cameras as jcams
from pose_splatter_tpu.utils import geometry as jgeo
from pose_splatter_torch.ops import carving as tcarv
from pose_splatter_torch.utils import cameras as tcams
from pose_splatter_torch.utils import geometry as tgeo

torch.set_num_threads(1)

C, H, W, FOC = 4, 48, 64, 70.0


def _cams():
    Ks = np.array([[[FOC, 0, W / 2 + 0.3], [0, FOC, H / 2 - 0.2], [0, 0, 1]]] * C,
                  np.float32)
    Es = np.stack([
        tcams.camera_extrinsic_spherical(1.3, np.pi / 3 + 0.1 * i,
                                         2 * np.pi * i / C + 0.05)
        for i in range(C)]).astype(np.float32)
    return Ks, Es


def _frame(seed=0):
    """Elliptical silhouettes with textured colors on a white background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    masks, imgs = [], []
    for c in range(C):
        cy, cx = H / 2 + rng.uniform(-2, 2), W / 2 + rng.uniform(-2, 2)
        m = ((yy - cy) ** 2 / 12.0 ** 2 + (xx - cx) ** 2 / 16.0 ** 2) < 1.0
        img = np.where(m[..., None], rng.uniform(0, 0.9, (H, W, 3)), 1.0)
        masks.append(m.astype(np.float32))
        imgs.append(img.astype(np.float32))
    return np.stack(masks), np.stack(imgs)


def test_cameras_copy_matches(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    Es = np.stack([jcams.camera_extrinsic_spherical(2.0, 1.0, 0.7 * i)
                   for i in range(C)])
    for i, E in enumerate(Es):
        np.testing.assert_array_equal(
            tcams.camera_extrinsic_spherical(2.0, 1.0, 0.7 * i), E)
    fn = tmp_path / "cams.h5"
    with h5py.File(fn, "w") as f:
        g = f.create_group("camera_parameters")
        g["rotation"] = Es[:, :3, :3]
        g["translation"] = Es[:, :3, 3]
        g["intrinsic"] = np.array([[[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]] * C)
    up_fn = tmp_path / "vertical_lines.npz"
    np.savez(up_fn, up=rng.normal(size=3))
    for kw in (dict(ds=2, up_fn=str(up_fn)), dict(load_up_direction=False,
                                                 holdout_views=[1])):
        for a, b in zip(jcams.get_cam_params(str(fn), **kw),
                        tcams.get_cam_params(str(fn), **kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clamp_z", [False, True])
def test_project_points(clamp_z):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 0.3, (500, 3)).astype(np.float32)
    Ks, Es = _cams()
    a = jgeo.project_points(jnp.asarray(pts), jnp.asarray(Ks), jnp.asarray(Es),
                            clamp_z=clamp_z)
    b = tgeo.project_points(torch.from_numpy(pts), torch.from_numpy(Ks),
                            torch.from_numpy(Es), clamp_z=clamp_z)
    # float32 einsums summed in another order: a few ulps of ~100 px.
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-4)
    a1 = jgeo.project_points(jnp.asarray(pts), jnp.asarray(Ks[0]),
                             jnp.asarray(Es[0]), clamp_z=clamp_z)
    b1 = tgeo.project_points(torch.from_numpy(pts), torch.from_numpy(Ks[0]),
                             torch.from_numpy(Es[0]), clamp_z=clamp_z)
    assert b1.shape == (500, 2)
    np.testing.assert_allclose(np.asarray(a1), b1.numpy(), rtol=1e-6, atol=1e-4)


def test_grid_transform_and_camera_positions():
    vi = [[2, 18], [0, 16], [4, 20]]
    g = tgeo.create_3d_grid(0.4, 24, vi)
    np.testing.assert_array_equal(jgeo.create_3d_grid(0.4, 24, vi), g)
    center = np.array([0.01, -0.02, 0.03], np.float32)
    a = jgeo.transform_grid(jnp.asarray(g), jnp.asarray(center), 0.7)
    b = tgeo.transform_grid(torch.from_numpy(g), torch.from_numpy(center), 0.7)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(jgeo.yaw_rotation(0.7)),
                               tgeo.yaw_rotation(0.7).numpy(), atol=1e-7)
    _, Es = _cams()
    np.testing.assert_allclose(
        np.asarray(jgeo.camera_positions(jnp.asarray(Es))),
        tgeo.camera_positions(torch.from_numpy(Es)).numpy(), atol=1e-6)


def test_visibility_pair_winners_exact():
    """One winner per pixel, ties in distance broken by voxel index."""
    rng = np.random.default_rng(2)
    N = 3000
    dists = rng.integers(0, 40, (C, N)).astype(np.float32) / 8.0  # many ties
    flat = rng.integers(0, 200, (C, N)).astype(np.int32)  # many collisions
    occ1 = rng.uniform(size=N) < 0.3
    occ2 = occ1 | (rng.uniform(size=N) < 0.3)
    a1, a2 = jcarv.ray_cast_visibility_pair(
        jnp.asarray(dists), jnp.asarray(flat), jnp.asarray(occ1), jnp.asarray(occ2))
    b1, b2 = tcarv.ray_cast_visibility_pair(
        torch.from_numpy(dists), torch.from_numpy(flat).long(),
        torch.from_numpy(occ1), torch.from_numpy(occ2), 200)
    np.testing.assert_array_equal(np.asarray(a1), b1.numpy())
    np.testing.assert_array_equal(np.asarray(a2), b2.numpy())
    # At most one visible voxel per (camera, pixel).
    for c in range(C):
        vis_pix = flat[c][b1[c].numpy()]
        assert len(vis_pix) == len(np.unique(vis_pix))


@pytest.mark.parametrize("angle", [0.0, 0.4])
def test_carve_volume_matches(angle):
    Ks, Es = _cams()
    masks, imgs = _frame()
    grid = tgeo.create_3d_grid(1.2, 32, [[8, 24]] * 3)
    center = np.array([0.004, -0.003, 0.002], np.float32)
    # Precondition for exact equality: both packages round every voxel to
    # the same pixel (a projection within an ulp of a rounding boundary
    # could legitimately land in the neighbour pixel under another einsum
    # order).
    pts = np.asarray(jgeo.transform_grid(jnp.asarray(grid), jnp.asarray(center),
                                         angle)).reshape(-1, 3).copy()
    pix_j = jgeo.project_points(jnp.asarray(pts), jnp.asarray(Ks),
                                jnp.asarray(Es), clamp_z=True)
    pix_t = tgeo.project_points(torch.from_numpy(pts), torch.from_numpy(Ks),
                                torch.from_numpy(Es), clamp_z=True)
    np.testing.assert_array_equal(
        np.asarray(jcarv._pixel_indices(pix_j, H, W)[2]),
        tcarv._pixel_indices(pix_t, H, W)[2].numpy())

    ref = np.asarray(jcarv.carve_volume(
        jnp.asarray(masks), jnp.asarray(imgs), jnp.asarray(center),
        jnp.float32(angle), jnp.asarray(grid), None, jnp.asarray(Ks),
        jnp.asarray(Es), volume_fill_color=0.38))
    got = tcarv.carve_volume(
        torch.from_numpy(masks), torch.from_numpy(imgs),
        torch.from_numpy(center), torch.tensor(angle, dtype=torch.float32),
        torch.from_numpy(grid), None, torch.from_numpy(Ks),
        torch.from_numpy(Es), volume_fill_color=0.38).numpy()
    assert got.shape == (4, 16, 16, 16)
    assert 0 < (ref[0] == 1.0).sum() < ref[0].size  # both thresholds carve
    np.testing.assert_array_equal(ref[0], got[0])  # occupancy exact
    # Colors: weighted sums over C views in another order (float32 ulps).
    np.testing.assert_allclose(ref[1:], got[1:], atol=1e-6)
