"""Config keys of the JAX configuration that the port's ``build_model``
must not drop: ``carve_visibility_cap`` raises until the capped carve is
ported, ``render_mode`` "pallas" (the JAX name of the port's "kernel")
builds the kernel path, "tiled" raises at build time rather than deep
inside the renderer. On the CPU, at a small size."""

import numpy as np
import pytest
import torch

from pose_splatter_torch.config import Config
from pose_splatter_torch.train.trainer import build_model, train_from_config
from pose_splatter_torch.utils.synthetic import ring_cameras

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


def test_carve_visibility_cap_raises():
    with pytest.raises(NotImplementedError, match="A.4"):
        _build(carve_visibility_cap=4096)
    # An explicit null is the exact carve, which the port runs.
    assert _build(carve_visibility_cap=None).render_mode == "kernel"


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
    with pytest.raises(NotImplementedError, match="A.7"):
        _build(render_mode="tiled")
    with pytest.raises(ValueError, match="render_mode"):
        _build(render_mode="splat")


def test_render_mode_argument_maps_too():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    model = build_model(_config(), render_mode="pallas", device="cpu",
                        cameras=(Ks, Es))
    assert model.render_mode == "kernel"


def test_remat_unets_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="A.6"):
        train_from_config(_config(remat_unets=True), device="cpu",
                          cameras=(np.eye(3)[None], np.eye(4)[None]))
