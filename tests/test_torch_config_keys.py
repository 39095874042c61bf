"""Config keys of the JAX configuration that the port's ``build_model``
must not drop: ``carve_visibility_cap`` and ``remat_unets`` reach the model
and change what it runs, ``render_mode`` "pallas" (the JAX name of the
port's "kernel") builds the kernel path, "tiled" builds the tiled
compositor, and an unknown mode raises at build time rather than deep
inside the renderer. On the CPU, at a small size."""

import numpy as np
import pytest
import torch

from pose_splatter_torch.config import Config
from pose_splatter_torch.train.trainer import build_model, train_from_config
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)

torch.set_num_threads(1)

C, H, W = 3, 32, 48


def _config(**kw):
    cfg = dict(image_width=W, image_height=H, grid_size=16, ell=0.3,
               volume_idx=[[0, 16]] * 3, holdout_views=[1],
               gaussian_mode="2d", min_n=8, max_n=64, num_unets=2,
               base_filters=4)
    cfg.update(kw)
    return Config(cfg)


def _build(**kw):
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    return build_model(_config(**kw), device="cpu", cameras=(Ks, Es))


def test_carve_visibility_cap_reaches_the_carve():
    """The key reaches the model (as ``tests/test_model.py``'s passthrough
    test holds for the JAX side), and its carve runs the compacted path: a
    cap below the occupied count overflows, changing only the colours."""
    model = _build(carve_visibility_cap=64)
    assert model.carve_visibility_cap == 64
    assert _build(carve_visibility_cap=None).carve_visibility_cap is None
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    grid = create_3d_grid(0.3, 16, [[0, 16]] * 3)
    f = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                         (0.09, 0.07, 0.06), n_frames=1, seed=0)
    obs = model.observed_views
    args = (f["mask"][0, obs], f["img"][0, obs], f["p_3d"][0], f["angle"][0])
    capped = model.carve(*args)
    model.carve_visibility_cap = None
    exact = model.carve(*args)
    assert int((exact[0] > 0).sum()) > 64  # the cap overflows
    assert torch.equal(capped[0], exact[0])
    assert float((capped[1:] - exact[1:]).abs().max()) > 1e-3


@pytest.mark.parametrize("mode,expect", [
    ("pallas", "kernel"), ("kernel", "kernel"), ("global", "global")])
def test_render_mode_names(mode, expect):
    model = _build(render_mode=mode)
    assert model.render_mode == expect
    # The mapped mode renders (the compositor's plain version on the CPU).
    with torch.no_grad():
        g = model.gaussians_from_volume(torch.linspace(
            -1, 4, 8 * 16 ** 3).reshape(8, -1))
        rgb, alpha, _ = model.render(g, [0])
    assert rgb.shape == (1, H, W, 3) and torch.isfinite(rgb).all()


def test_tiled_render_mode_raises_at_build():
    """"tiled" builds and renders (with its tile capacity counted in the
    overflow); an unknown name still raises at build time."""
    model = _build(render_mode="tiled")
    assert model.render_mode == "tiled"
    model.tile_capacity = 4
    with torch.no_grad():
        g = model.gaussians_from_volume(torch.linspace(
            -1, 4, 8 * 16 ** 3).reshape(8, -1))
        # 64 Gaussians of 2.7 px about the centre: the one (64, 128) tile
        # keeps 4 of them (pixel-space 2D renders once for every view).
        g.update(means2d=g["means2d"] + torch.tensor([W / 2, H / 2]),
                 log_scales2d=torch.ones_like(g["log_scales2d"]))
        rgb, alpha, overflow = model.render(g, [0, 2])
    assert rgb.shape == (2, H, W, 3) and torch.isfinite(rgb).all()
    assert int(overflow) == 64 - 4 and float(alpha.max()) > 0.01
    with pytest.raises(ValueError, match="render_mode"):
        _build(render_mode="splat")


def test_train_from_config_trains_a_tiled_model(tmp_path):
    """A config with ``render_mode`` "tiled" trains: two steps and a
    validation pass through the tiled compositor's O(P) backward."""
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    grid = create_3d_grid(0.3, 16, [[0, 16]] * 3)
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.09, 0.07, 0.06), n_frames=3, seed=0)
    obs = [0, 2]
    train = FrameSet({k: v[:2] for k, v in frames.items()}, obs)
    valid = FrameSet({k: v[2:] for k, v in frames.items()}, obs, split="valid")
    config = _config(project_directory=str(tmp_path),
                     model_fn="checkpoint.pt", render_mode="tiled", lr=1e-3,
                     img_lambda=0.5, ssim_lambda=0.1, valid_every=1,
                     save_every=5)
    state, losses, vlosses = train_from_config(
        config, epochs=1, device="cpu", cameras=(Ks, Es),
        datasets=(train, valid), max_batches=2)
    assert state.model.render_mode == "tiled" and state.step == 2
    assert all(np.isfinite(x) for x in losses[0]) and np.isfinite(vlosses[0])
    assert all(torch.isfinite(p).all() for p in state.model.net.parameters())


def test_render_mode_argument_maps_too():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    model = build_model(_config(), render_mode="pallas", device="cpu",
                        cameras=(Ks, Es))
    assert model.render_mode == "kernel"


def test_remat_unets_reaches_the_net():
    """``remat_unets`` builds a net that recomputes its U-Nets in the
    backward: the final U-Net's forward runs twice in a train step."""
    assert not _build().net.remat
    model = _build(remat_unets=True)
    assert model.net.remat
    calls = []
    model.net.final_unet.register_forward_pre_hook(lambda *a: calls.append(1))
    vol = torch.rand(1, 16, 16, 16, 4)
    stats = {}
    model.net.process_volume(vol, stats).square().mean().backward()
    assert len(calls) == 2 and stats
