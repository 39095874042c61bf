"""The port's 3D ``rasterize`` against the JAX package's: ``"kernel"`` mode
(the compositors' plain versions on CPU tensors) against ``mode="pallas"``
(the Pallas kernels in interpret mode) and ``"global"`` against
``"global"``, values and gradients; an empty scene, backgrounds, the
overflow count, depth ties and ``permute_rows``' backward."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.ops import rasterize_pallas as jp
from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk

# The JAX package's ops/__init__ re-exports the function ``rasterize``
# under the module's name.
jr = importlib.import_module("pose_splatter_tpu.ops.rasterize")

torch.set_num_threads(1)

W, H = 160, 48  # 2 x 6 tiles of (8, 128), the right column half outside


def _cameras():
    """Two cameras: the identity, and one turned 0.3 rad about y and
    shifted, so the second sees other depths and overlaps."""
    K = np.array([[100.0, 0, 80.0], [0, 100.0, 24.0], [0, 0, 1]], np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    E2 = np.array([[c, 0, s, -0.3], [0, 1, 0, 0.05], [-s, 0, c, 0.2],
                   [0, 0, 0, 1]], np.float32)
    return np.stack([np.eye(4, dtype=np.float32), E2]), np.stack([K, K])


def _scene(n, seed):
    """Gaussians in front of the cameras. Depths on a 0.05 grid: many equal
    depths among overlapping Gaussians, so the sort's tie order shows in
    the image of the identity camera (where depth = z exactly)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, [0.35, 0.12], (n, 2)),
                            2.0 + 0.05 * np.round(rng.normal(0, 0.1, (n, 1))
                                                  / 0.05)], 1)
    q = rng.normal(size=(n, 4))
    q[:, 0] = np.sign(q[:, 0]) * np.maximum(np.abs(q[:, 0]), 0.3)
    g = dict(means=means, quats=q,
             scales=np.exp(rng.normal(-3.3, 0.3, (n, 3))),
             opacities=rng.uniform(0.3, 0.95, n),
             colors=rng.uniform(0, 1, (n, 3)))
    return {k: v.astype(np.float32) for k, v in g.items()}


NAMES = ("means", "quats", "scales", "opacities", "colors")


def _jax(g, valid, bg, mode, **kw):
    Es, Ks = _cameras()
    wr = np.random.default_rng(9).uniform(0, 1, (2, H, W, 3)).astype(np.float32)

    def loss(*args):
        rgb, alpha, ov = jr.rasterize(
            *args, jnp.asarray(Es), jnp.asarray(Ks), W, H,
            valid=jnp.asarray(valid), backgrounds=jnp.asarray(bg), mode=mode,
            return_overflow=True, **kw)
        return (rgb * wr).sum() + (alpha ** 2).sum(), (rgb, alpha, ov)

    with pltpu.force_tpu_interpret_mode():
        grads, (rgb, alpha, ov) = jax.grad(loss, argnums=tuple(range(5)),
                                           has_aux=True)(
            *[jnp.asarray(g[k]) for k in NAMES])
    return np.asarray(rgb), np.asarray(alpha), int(ov), [np.asarray(x) for x in grads], wr


def _torch(g, valid, bg, mode, wr, **kw):
    Es, Ks = _cameras()
    args = [torch.from_numpy(g[k]).requires_grad_(True) for k in NAMES]
    rgb, alpha, ov = tr.rasterize(
        *args, torch.from_numpy(Es), torch.from_numpy(Ks), W, H,
        valid=torch.from_numpy(valid), backgrounds=torch.from_numpy(bg),
        mode=mode, return_overflow=True, **kw)
    ((rgb * torch.from_numpy(wr)).sum() + (alpha ** 2).sum()).backward()
    return (rgb.detach().numpy(), alpha.detach().numpy(), int(ov),
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize("mode,jmode,kw", [
    ("kernel", "pallas", {}),
    ("kernel", "pallas", {"tile_expand": 2}),
    ("global", "global", {})])
def test_rasterize_matches_jax(mode, jmode, kw):
    g = _scene(70, 0)
    valid = np.random.default_rng(1).uniform(size=70) < 0.9
    bg = np.array([[1.0, 0.9, 0.8], [0.2, 0.3, 0.4]], np.float32)
    ref_rgb, ref_alpha, ref_ov, ref_g, wr = _jax(g, valid, bg, jmode, **kw)
    rgb, alpha, ov, grads = _torch(g, valid, bg, mode, wr, **kw)
    # Transmittance products in another order: float32 rounding only; the
    # gates (skip, clamp, T(1 - a) >= 1e-4) take the same branches.
    np.testing.assert_allclose(ref_rgb, rgb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref_alpha, alpha, rtol=0, atol=1e-5)
    assert ref_ov == ov
    if "tile_expand" in kw:
        assert ov > 0  # truncated spans are counted
    assert alpha.max() > 0.9  # dense enough to reach the early stop
    for name, r, got in zip(NAMES, ref_g, grads):
        # Sums over pixels and suffix sums over each tile's rows, taken in
        # another order: within 3e-4 of each tensor's largest entry.
        np.testing.assert_allclose(r, got, rtol=0,
                                   atol=3e-4 * np.abs(r).max(), err_msg=name)


def test_depth_ties_follow_the_stable_order():
    """Trap: torch.argsort is unstable by default, jnp.argsort stable. The
    scene holds equal depths among overlapping Gaussians, and the port
    sorts stably: its depth order is JAX's, invalid rows (+inf) last in
    index order."""
    g = _scene(70, 0)
    valid = np.random.default_rng(1).uniform(size=70) < 0.9
    z = g["means"][:, 2]
    assert len(np.unique(z[valid])) < valid.sum() // 3  # many ties
    keys = np.where(valid, z, np.inf).astype(np.float32)
    ref = np.asarray(jnp.argsort(jnp.asarray(keys)))
    got = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    np.testing.assert_array_equal(ref, got)


def test_empty_scene_shows_the_background():
    g = _scene(8, 2)
    Es, Ks = _cameras()
    rgb, alpha, ov = tr.rasterize(
        *[torch.from_numpy(g[k]) for k in NAMES], torch.from_numpy(Es),
        torch.from_numpy(Ks), W, H, valid=torch.zeros(8, dtype=torch.bool),
        backgrounds=torch.tensor([0.5, 0.5, 0.5]), return_overflow=True)
    assert float(alpha.max()) == 0.0 and int(ov) == 0
    assert torch.equal(rgb, torch.full((2, H, W, 3), 0.5))


def test_backgrounds_by_transmittance():
    """A [3] background equals the same colour given per camera, and both
    are the unblended image plus (1 - alpha) times the colour."""
    g = {k: torch.from_numpy(v) for k, v in _scene(40, 3).items()}
    Es, Ks = (torch.from_numpy(x) for x in _cameras())
    args = [g[k] for k in NAMES] + [Es, Ks, W, H]
    bare = tr.rasterize(*args)
    one = tr.rasterize(*args, backgrounds=torch.tensor([0.1, 0.5, 0.9]))
    per = tr.rasterize(*args, backgrounds=torch.tensor([[0.1, 0.5, 0.9]] * 2))
    assert torch.equal(one[0], per[0]) and torch.equal(one[1], bare[1])
    expect = bare[0] + (1 - bare[1][..., None]) * torch.tensor([0.1, 0.5, 0.9])
    assert torch.equal(one[0], expect)


def test_permute_rows_backward_gathers_by_the_inverse():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, tk.F)).astype(np.float32)
    order = rng.permutation(50)
    g = rng.normal(size=(50, tk.F)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jp.permute_rows(v, jnp.asarray(order)),
                     jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tk.permute_rows(xt, torch.from_numpy(order))
    assert torch.equal(out, xt[torch.from_numpy(order)])
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]),
                                  xt.grad.numpy())
    inv = np.argsort(order)
    np.testing.assert_array_equal(xt.grad.numpy(), g[inv])


def test_rasterize_rejects_an_unknown_mode():
    g = _scene(4, 5)
    Es, Ks = _cameras()
    with pytest.raises(ValueError, match="splat"):
        tr.rasterize(*[torch.from_numpy(g[k]) for k in NAMES],
                     torch.from_numpy(Es), torch.from_numpy(Ks), W, H,
                     mode="splat")
