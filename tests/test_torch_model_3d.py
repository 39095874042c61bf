"""The port's 3D ``PoseSplatter`` (eval forward, Gaussians and pose
transform, ``render``, ``splat``) against the JAX package's, and
``train_from_config`` on a tiny 3D config, at a small size: 3 cameras of
32×32, grid 16, up to 512 Gaussians, 2 U-Nets of width 4.

Both models get the same weights (seeded numpy values moved through the
bridge) and the same synthetic frames. The JAX model renders through its
Pallas kernels in interpret mode (``render_mode="pallas"``), the port
through the compositors' plain versions (CPU tensors).

Conic mode gates each contribution (the 1/255 skip, the 0.999 clamp,
T·(1 − a) >= 1e-4), and the two sides round differently upstream of the
gates: XLA's jitted CPU code fuses multiply-adds that PyTorch rounds
apart (its jitted projection differs from its own eager one in most conic
entries). A pixel-Gaussian pair within that rounding of a gate would flip
and move one pixel by up to 1/255. The seeded scenes hold no such pair
(the first frame of a 2-frame draw; the 1-frame draw of the same seed
holds one), so images agree within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train.trainer import train_from_config
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

C, H, W = 3, 32, 32
KW = dict(ell=0.3, grid_size=16, min_n=32, max_n=512,
          volume_idx=[[0, 16]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="3d", holdout_views=[1], volume_fill_color=0.38)
AXES = (0.09, 0.07, 0.06)  # the synthetic ellipsoid's semi-axes


def _frames(Ks, Es, n):
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    return synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0), AXES,
                            n_frames=n, seed=0)


@pytest.fixture(scope="module")
def setup():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    # Gaussians of about 3 px at the cameras' distance: with the low
    # opacities that random weights give, the images still reach alpha 0.5.
    variables["params"]["scale"] = np.full((1,), np.log(0.03), np.float32)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    tm.net.load_state_dict(variables_from_flax(variables))
    return jm, variables, tm, _frames(Ks, Es, 2)


def _inputs(tm, frames):
    obs = tm.observed_views
    return (frames["mask"][0, obs], frames["img"][0, obs], frames["p_3d"][0],
            frames["angle"][0])


def test_bridge_carries_the_14_wide_head(setup):
    _, variables, tm, _ = setup
    sd = variables_from_flax(variables)
    assert tm.num_gaussian_params == 14
    assert sd["head2.weight"].shape == (14, 128) and sd["head2.bias"].shape == (14,)
    assert torch.equal(tm.net.head2.weight, sd["head2.weight"])


def test_eval_forward_matches(setup):
    jm, variables, tm, frames = setup
    mask, img, p_3d, angle = _inputs(tm, frames)
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


def test_gaussians_and_pose_transform_match(setup):
    """The 3D head split [4, 3, 1, 3, 3], means at the voxel centres plus
    2·voxel·tanh(Δ), colours clipped, then the yaw and shift of the frame
    (quaternions with w >= 0)."""
    jm, variables, tm, frames = setup
    mask, img, p_3d, angle = _inputs(tm, frames)
    jv = jax.tree.map(jnp.asarray, variables)
    jvol = jm.carve(jnp.asarray(mask), jnp.asarray(img), jnp.asarray(p_3d),
                    jnp.float32(angle))
    jflat = jm.net.apply(jv, jnp.transpose(jvol, (1, 2, 3, 0))[None], False,
                         method="process_volume")
    ref = jm.apply_pose_transform_3d(jm.gaussians_from_volume(jv, jflat),
                                     jnp.float32(angle), jnp.asarray(p_3d))
    with torch.no_grad():
        flat = tm.net.process_volume(
            tm.carve(mask, img, p_3d, angle).permute(1, 2, 3, 0)[None])
        got = tm.apply_pose_transform_3d(tm.gaussians_from_volume(flat),
                                         angle, p_3d)
    assert sorted(ref) == sorted(got)
    np.testing.assert_array_equal(np.asarray(ref["valid"]), got["valid"].numpy())
    assert int(got["valid"].sum()) >= KW["min_n"]
    for k in ("means", "log_scales", "quats", "colors", "logit_opacities"):
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert (got["quats"][:, 0] >= 0).all()


def _gaussians(tm, n, seed):
    rng = np.random.default_rng(seed)
    voxels = tm.grid.reshape(-1, 3).numpy()
    q = rng.normal(size=(n, 4))
    q[:, 0] = np.sign(q[:, 0]) * np.maximum(np.abs(q[:, 0]), 0.3)
    return dict(
        means=voxels[rng.choice(len(voxels), n, replace=False)]
        + rng.normal(0, 0.01, (n, 3)),
        quats=q,
        log_scales=np.log(0.012) + rng.normal(0, 0.3, (n, 3)),
        colors=rng.uniform(0, 1, (n, 3)),
        logit_opacities=rng.normal(0.5, 1.0, n),
    )


def test_render_matches(setup):
    jm, _, tm, _ = setup
    g = {k: v.astype(np.float32) for k, v in _gaussians(tm, 96, 11).items()}
    g["valid"] = np.random.default_rng(12).uniform(size=96) < 0.9
    views = np.array([0, 2], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.render({k: jnp.asarray(v) for k, v in g.items()},
                        jnp.asarray(views), return_overflow=True)
    rgb, alpha, overflow = tm.render(
        {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}, views)
    assert rgb.shape == (2, H, W, 3)
    np.testing.assert_allclose(np.asarray(ref[0]), rgb.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref[1]), alpha.numpy(), atol=1e-5)
    assert int(ref[2]) == int(overflow)
    assert float(alpha.max()) > 0.5


def test_splat_matches(setup):
    """``splat`` at another image size, with its radius clip of 2 px."""
    jm, _, tm, _ = setup
    g = _gaussians(tm, 80, 13)
    Ks, Es = ring_cameras(2, 48, 40, focal=80.0, radius=0.6)
    args = (g["means"], g["quats"], np.exp(g["log_scales"]),
            1 / (1 + np.exp(-g["logit_opacities"])), g["colors"], Es, Ks)
    args = [np.asarray(a, np.float32) for a in args]
    with pltpu.force_tpu_interpret_mode():
        ref = jm.splat(*[jnp.asarray(a) for a in args], 48, 40)
    got = tm.splat(*[torch.from_numpy(a) for a in args], 48, 40)
    assert got[0].shape == (2, 40, 48, 3)
    np.testing.assert_allclose(np.asarray(ref[0]), got[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref[1]), got[1].numpy(), atol=1e-5)
    assert float(got[0].min()) >= 0 and float(got[0].max()) <= 1


def test_train_from_config_3d(tmp_path, capsys):
    """A fresh 3D start is ``init_unet_primary_skip`` only: the shared
    log-scale stays at -5.5 and the head's bias at 0 (no 2D centring)."""
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    frames = _frames(Ks, Es, 3)
    obs = [0, 2]
    train = FrameSet({k: v[:2] for k, v in frames.items()}, obs)
    valid = FrameSet({k: v[2:] for k, v in frames.items()}, obs, split="valid")
    config = Config(dict(
        project_directory=str(tmp_path), model_fn="checkpoint.pt",
        image_width=W, image_height=H, grid_size=KW["grid_size"],
        ell=KW["ell"], volume_idx=KW["volume_idx"], holdout_views=[1],
        volume_fill_color=0.38, gaussian_mode="3d", gaussian_config={},
        min_n=KW["min_n"], max_n=KW["max_n"], num_unets=2, base_filters=4,
        lr=1e-3, img_lambda=0.5, ssim_lambda=0.0, valid_every=1,
        save_every=5))
    state, losses, vlosses = train_from_config(
        config, epochs=1, device="cpu", cameras=(Ks, Es),
        datasets=(train, valid), max_batches=2)
    assert state.step == 2 and len(losses) == 1 and len(vlosses) == 1
    assert all(np.isfinite(x) for x in losses[0]) and np.isfinite(vlosses[0])
    net = state.model.net
    assert state.model.gaussian_mode == "3d" and net.head2.out_features == 14
    # Two Adam steps of lr 1e-3 move a parameter by at most about 2e-3.
    assert abs(float(net.scale.detach()) + 5.5) <= 2.1e-3
    assert float(net.head2.bias.detach().abs().max()) <= 2.1e-3
    assert "epoch 1:" in capsys.readouterr().out
