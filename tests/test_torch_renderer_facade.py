"""The port's renderer facade (``pose_splatter_torch/ops/renderer.py``):
``tests/test_renderer_facade.py`` on the port, and each facade's render
against the JAX facade's on the same parameters (3D in its default
``"tiled"`` mode and in ``"global"``, 2D in ``"global"`` and ``"tiled"``)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_torch.ops.renderer import (
    GaussianRenderer,
    GaussianRenderer2D,
    GaussianRenderer3D,
    create_renderer,
)

jrend = importlib.import_module("pose_splatter_tpu.ops.renderer")

torch.set_num_threads(1)


class TestFactory:
    def test_abc_not_instantiable(self):
        with pytest.raises(TypeError):
            GaussianRenderer(64, 64)

    def test_modes_and_case_insensitivity(self):
        assert isinstance(create_renderer("2d", 32, 32), GaussianRenderer2D)
        assert isinstance(create_renderer("3D", 32, 32), GaussianRenderer3D)
        with pytest.raises(ValueError):
            create_renderer("4d", 32, 32)

    def test_kwargs_forwarding(self):
        r = create_renderer("2d", 32, 32, sigma_cutoff=4.0, kernel_size=7,
                            batch_size=5)
        assert r.sigma_cutoff == 4.0
        assert r.kernel_size == 7

    def test_num_params(self):
        assert create_renderer("3d", 32, 32).get_num_params() == 14
        assert create_renderer("2d", 32, 32).get_num_params() == 9

    def test_default_modes(self):
        assert create_renderer("3d", 32, 32).mode == "tiled"
        assert create_renderer("2d", 32, 32).mode == "global"

    def test_background_validation(self):
        r = create_renderer("2d", 32, 32)
        with pytest.raises(ValueError):
            r.set_background_color(torch.zeros(4))
        r.set_background_color([1.0, 0.5, 0.0])
        assert np.allclose(r.background_color.numpy(), [1.0, 0.5, 0.0])


class TestRender:
    def test_3d_unified_params(self):
        r = create_renderer("3d", 32, 32, render_mode="global")
        params = torch.cat([
            torch.tensor([[0.0, 0.0, 2.0]]),  # means
            torch.full((1, 3), -3.0),  # log scales
            torch.tensor([[1.0, 0, 0, 0]]),  # quats
            torch.tensor([[1.0, 0.0, 0.0]]),  # colors
            torch.tensor([[2.0]]),  # logit opacity
        ], dim=1)
        K = torch.tensor([[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]])
        rgb, alpha = r.render(params, torch.eye(4), K)
        assert rgb.shape == (32, 32, 3)
        assert alpha.shape == (32, 32)
        assert float(alpha[16, 16]) > 0.5

    def test_3d_wrong_param_count_raises(self):
        r = create_renderer("3d", 32, 32)
        with pytest.raises(ValueError):
            r.render(torch.zeros((5, 9)), torch.eye(4), torch.eye(3))

    def test_2d_wrong_param_count_raises(self):
        r = create_renderer("2d", 32, 32)
        with pytest.raises(ValueError):
            r.render(torch.zeros((5, 14)))

    def test_2d_unified_params(self):
        r = create_renderer("2d", 32, 32)
        r.set_background_color(torch.zeros(3))
        params = torch.cat([
            torch.tensor([[16.0, 16.0]]),  # means 2d
            torch.full((1, 2), 1.0),  # log scales
            torch.zeros((1, 1)),  # rotation
            torch.tensor([[0.0, 1.0, 0.0]]),  # colors
            torch.tensor([[3.0]]),  # logit opacity
        ], dim=1)
        rgb, alpha = r.render(params, None, None)
        assert float(rgb[16, 16, 1]) > 0.5
        assert float(alpha[0, 0]) < 0.1

    def test_cross_renderer_shape_consistency(self):
        r3 = create_renderer("3d", 24, 40, render_mode="global")
        r2 = create_renderer("2d", 24, 40)
        p3 = torch.zeros((3, 14))
        p3[:, 2] = 2.0
        p3[:, 6] = 1.0
        p2 = torch.zeros((3, 9))
        K = torch.tensor([[50.0, 0, 12], [0, 50.0, 20], [0, 0, 1]])
        out3 = r3.render(p3, torch.eye(4), K)
        out2 = r2.render(p2, None, None)
        assert out3[0].shape == out2[0].shape == (40, 24, 3)
        assert out3[1].shape == out2[1].shape == (40, 24)


# ----------------------------------------------------------------------------
# Against the JAX facade.
# ----------------------------------------------------------------------------

W, H = 40, 36


def _params_3d(n=30, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.concatenate([rng.normal(0, [0.25, 0.2], (n, 2)),
                        rng.normal(2.0, 0.1, (n, 1))], 1),
        rng.normal(-3.0, 0.3, (n, 3)), rng.normal(size=(n, 4)),
        rng.uniform(-0.2, 1.2, (n, 3)), rng.normal(1.0, 1.0, (n, 1)),
    ], 1).astype(np.float32)


def _params_2d(n=30, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1),
        rng.normal(0.8, 0.3, (n, 2)), rng.uniform(0, np.pi, (n, 1)),
        rng.uniform(-0.2, 1.2, (n, 3)), rng.normal(1.0, 1.0, (n, 1)),
    ], 1).astype(np.float32)


@pytest.mark.parametrize("mode", [None, "global"])
def test_3d_render_matches_jax(mode):
    """The 3D facade (default "tiled") equals the JAX facade's within 1e-4;
    the scene holds no pixel-Gaussian pair near a conic gate."""
    kw = {} if mode is None else dict(render_mode=mode)
    p = _params_3d()
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    rj = jrend.create_renderer("3d", W, H, **kw)
    rt = create_renderer("3d", W, H, **kw)
    for r in (rj, rt):
        r.set_background_color([0.1, 0.2, 0.3])
    a = rj.render(jnp.asarray(p), jnp.eye(4), jnp.asarray(K))
    b = rt.render(torch.from_numpy(p), torch.eye(4), torch.from_numpy(K))
    assert float(b[1].max()) > 0.5
    for x, y in zip(a, b):
        assert np.abs(np.asarray(x) - y.numpy()).max() <= 1e-4


@pytest.mark.parametrize("mode", [None, "tiled"])
def test_2d_render_matches_jax(mode):
    kw = {} if mode is None else dict(render_mode=mode)
    p = _params_2d()
    rj = jrend.create_renderer("2d", W, H, sigma_cutoff=3.5, **kw)
    rt = create_renderer("2d", W, H, sigma_cutoff=3.5, **kw)
    a = rj.render(jnp.asarray(p))
    b = rt.render(torch.from_numpy(p))
    assert float(b[1].max()) > 0.5
    for x, y in zip(a, b):
        assert np.abs(np.asarray(x) - y.numpy()).max() <= 1e-5
