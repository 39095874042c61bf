"""The port's ``"tiled"`` compositor and its O(P) ``composite_pixels``
against the JAX package's, on the CPU at small sizes.

- ``bin_gaussians`` equals the JAX binning exactly (indices, valid flags,
  overflow) on a scene with coincident Gaussians and a capacity that
  overflows;
- ``rasterize_2d(mode="tiled")`` and ``rasterize(mode="tiled")`` against
  the JAX ``"tiled"``: values within 1e-5 (2D) and 1e-4 (3D), gradients
  within 1e-3 of each tensor's largest entry. The 3D scene's conic gates
  (the 1/255 skip, the 0.999 clamp, T·(1 − a) >= 1e-4) hold no
  pixel-Gaussian pair within float32 rounding of a gate, so no pixel flips;
- the counterparts of ``tests/test_rasterize.py``'s tiled-vs-global and
  tile-capacity overflow tests;
- ``composite_pixels`` (the autograd Function with the O(P) backward)
  against ``composite_pixels_ref`` (autograd through the scan) and against
  the JAX custom VJP, a float64 gradcheck, and what its backward saves.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_torch.ops import rasterize as tr

jr = importlib.import_module("pose_splatter_tpu.ops.rasterize")

torch.set_num_threads(1)

H, W = 40, 72
TILE = (16, 32)  # 3 x 3 tiles, the last row and column partly outside


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


# ----------------------------------------------------------------------------
# Binning.
# ----------------------------------------------------------------------------

def test_bin_gaussians_exact():
    """Coincident Gaussians (ties of position and radius), invalid ones and
    a capacity that overflows most tiles: the port keeps the same
    Gaussians in the same order."""
    rng = np.random.default_rng(3)
    n = 90
    center = rng.uniform(-10, 80, (n, 2)).astype(np.float32)
    center[30:45] = center[30]  # ties
    center[50:60] = [31.5, 15.5]  # on tile corners
    radius = rng.uniform(0, 14, n).astype(np.float32)
    radius[30:45] = radius[30]
    valid = rng.uniform(size=n) > 0.15
    j_origins, _, _ = jr._tile_grid(H, W, TILE)
    t_origins, _, _ = tr._tile_grid(H, W, TILE)
    np.testing.assert_array_equal(np.asarray(j_origins), t_origins.numpy())
    for cap in (7, 20, n):
        a = jr.bin_gaussians(jnp.asarray(center), jnp.asarray(radius),
                             jnp.asarray(valid), j_origins, TILE, cap)
        b = tr.bin_gaussians(torch.from_numpy(center), torch.from_numpy(radius),
                             torch.from_numpy(valid), t_origins, TILE, cap)
        np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
        np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
        np.testing.assert_array_equal(np.asarray(a.overflow), b.overflow.numpy())
        if cap == 7:
            assert int(b.overflow.sum()) > 0


# ----------------------------------------------------------------------------
# rasterize_2d / rasterize in tiled mode against the JAX "tiled".
# ----------------------------------------------------------------------------

def _scene_2d(n, seed):
    rng = np.random.default_rng(seed)
    g = (np.stack([rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)], 1),
         np.exp(rng.normal(0.9, 0.4, (n, 2))), rng.uniform(0, np.pi, n),
         rng.uniform(0.3, 0.95, n), rng.uniform(0, 1, (n, 3)))
    return [x.astype(np.float32) for x in g]


@pytest.mark.parametrize("cap", [None, 12])
def test_rasterize_2d_tiled_matches_jax(cap):
    g = _scene_2d(70, 1)
    valid = np.random.default_rng(2).uniform(size=70) > 0.1
    wr = np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(np.float32)
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    kw = dict(mode="tiled", tile_shape=TILE, tile_capacity=cap,
              return_overflow=True)

    def jloss(*a):
        rgb, alpha, ov = jr.rasterize_2d(*a, W, H, valid=jnp.asarray(valid),
                                         background=jnp.asarray(bg), **kw)
        return (rgb * wr).sum() + (alpha ** 2).sum(), (rgb, alpha, ov)

    jg, (jrgb, jalpha, jov) = jax.grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(*map(jnp.asarray, g))
    ts = [torch.from_numpy(x).requires_grad_() for x in g]
    rgb, alpha, ov = tr.rasterize_2d(*ts, W, H, valid=torch.from_numpy(valid),
                                     background=torch.from_numpy(bg), **kw)
    ((rgb * torch.from_numpy(wr)).sum() + (alpha ** 2).sum()).backward()
    assert np.abs(np.asarray(jrgb) - rgb.detach().numpy()).max() <= 1e-5
    assert np.abs(np.asarray(jalpha) - alpha.detach().numpy()).max() <= 1e-5
    assert int(jov) == int(ov) and (int(ov) > 0) == (cap is not None)
    for a, b in zip(jg, ts):
        assert _rel(a, b.grad.numpy()) <= 1e-3


def _cameras():
    K = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    c, s = np.cos(0.25), np.sin(0.25)
    E2 = np.array([[c, 0, s, -0.2], [0, 1, 0, 0.03], [-s, 0, c, 0.1],
                   [0, 0, 0, 1]], np.float32)
    return np.stack([np.eye(4, dtype=np.float32), E2]), np.stack([K, K])


def _scene_3d(n, seed):
    rng = np.random.default_rng(seed)
    g = (np.concatenate([rng.normal(0, [0.3, 0.15], (n, 2)),
                         rng.normal(2.0, 0.1, (n, 1))], 1),
         rng.normal(size=(n, 4)), np.exp(rng.normal(-3.2, 0.3, (n, 3))),
         rng.uniform(0.3, 0.95, n), rng.uniform(0, 1, (n, 3)))
    return [x.astype(np.float32) for x in g]


@pytest.mark.parametrize("cap", [None, 10])
def test_rasterize_3d_tiled_matches_jax(cap):
    g = _scene_3d(60, 4)
    Es, Ks = _cameras()
    wr = np.random.default_rng(9).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    kw = dict(mode="tiled", tile_shape=TILE, tile_capacity=cap,
              return_overflow=True)

    def jloss(*a):
        rgb, alpha, ov = jr.rasterize(*a, jnp.asarray(Es), jnp.asarray(Ks),
                                      W, H, backgrounds=jnp.asarray(bg), **kw)
        return (rgb * wr).sum() + (alpha ** 2).sum(), (rgb, alpha, ov)

    jg, (jrgb, jalpha, jov) = jax.grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(*map(jnp.asarray, g))
    ts = [torch.from_numpy(x).requires_grad_() for x in g]
    rgb, alpha, ov = tr.rasterize(*ts, torch.from_numpy(Es),
                                  torch.from_numpy(Ks), W, H,
                                  backgrounds=torch.from_numpy(bg), **kw)
    ((rgb * torch.from_numpy(wr)).sum() + (alpha ** 2).sum()).backward()
    assert np.abs(np.asarray(jrgb) - rgb.detach().numpy()).max() <= 1e-4
    assert np.abs(np.asarray(jalpha) - alpha.detach().numpy()).max() <= 1e-4
    assert int(jov) == int(ov) and (int(ov) > 0) == (cap is not None)
    for a, b in zip(jg, ts):
        assert _rel(a, b.grad.numpy()) <= 1e-3


def test_tiled_matches_global():
    """``Test3DRasterize::test_tiled_matches_global`` on the port: with
    room for every Gaussian, tiles give the global image."""
    rng = np.random.default_rng(0)
    n = 40
    g = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.normal(0, 0.3, (n, 3)) + [0, 0, 2.0], rng.normal(size=(n, 4)),
        np.exp(rng.normal(-3.5, 0.3, (n, 3))), rng.uniform(0.2, 0.95, n),
        rng.uniform(0, 1, (n, 3)))]
    K = torch.tensor([[[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]]])
    eye = torch.eye(4)[None]
    a = tr.rasterize(*g, eye, K, 64, 64, mode="global")
    b = tr.rasterize(*g, eye, K, 64, 64, mode="tiled", tile_shape=(16, 32))
    assert torch.allclose(a[0], b[0], atol=1e-5)
    assert torch.allclose(a[1], b[1], atol=1e-5)


def test_tiled_capacity_overflow_counted():
    """``TestOverflowContract::test_tiled_capacity_overflow_counted``."""
    n = 64
    rng = np.random.default_rng(0)
    means2d = torch.from_numpy(
        (np.full((n, 2), 16.0) + rng.normal(0, 1.0, (n, 2))).astype(np.float32))
    scales2d = torch.full((n, 2), 4.0)
    rot = torch.zeros(n)
    opac = torch.full((n,), 0.5)
    colors = torch.ones((n, 3)) * 0.5
    _, alpha, ov = tr.rasterize_2d(
        means2d, scales2d, rot, opac, colors, 32, 32, mode="tiled",
        tile_shape=(8, 128), tile_capacity=8, return_overflow=True)
    assert int(ov) > 0
    _, alpha2, ov2 = tr.rasterize_2d(
        means2d, scales2d, rot, opac, colors, 32, 32, mode="tiled",
        tile_shape=(8, 128), tile_capacity=n, return_overflow=True)
    assert int(ov2) == 0
    assert float((alpha - alpha2).abs().max()) > 1e-3


# ----------------------------------------------------------------------------
# composite_pixels: the O(P) backward.
# ----------------------------------------------------------------------------

P = 60


def _pixels(dtype=np.float32, offset=0.0):
    yy, xx = np.mgrid[0:6, 0:10]
    return ((xx.reshape(-1) + offset).astype(dtype),
            (yy.reshape(-1) + offset).astype(dtype))


def _feats(kind, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mean = np.stack([rng.uniform(0, 10, n), rng.uniform(0, 6, n)], 1)
    if kind == "ellipse":
        f = (mean, np.exp(rng.normal(0.5, 0.3, (n, 2))),
             rng.uniform(0, np.pi, n), rng.uniform(0.3, 0.9, n))
    else:
        f = (mean, np.stack([rng.uniform(0.2, 0.6, n), rng.uniform(-.05, .05, n),
                             rng.uniform(0.2, 0.6, n)], 1),
             rng.uniform(0.3, 0.95, n))
    colors = rng.uniform(0, 1, (n, 3))
    valid = rng.uniform(size=n) > 0.2
    return [x.astype(dtype) for x in f], colors.astype(dtype), valid


CASES = [("ellipse", False), ("ellipse", True), ("conic", True)]


def _alpha_fns(kind):
    return ((jr._alpha_ellipse, tr._alpha_ellipse) if kind == "ellipse"
            else (jr._alpha_conic, tr._alpha_conic))


def _run(fn, xs, ys, feats, colors, valid, alpha_fn, early_stop, g):
    f = [torch.from_numpy(x).requires_grad_() for x in feats]
    c = torch.from_numpy(colors).requires_grad_()
    rgb, alpha = fn(torch.from_numpy(xs), torch.from_numpy(ys), tuple(f), c,
                    torch.from_numpy(valid), alpha_fn, 8, early_stop)
    ((rgb * torch.from_numpy(g[0])).sum() + (alpha * torch.from_numpy(g[1])).sum()
     ).backward()
    return rgb.detach(), alpha.detach(), [x.grad for x in f] + [c.grad]


@pytest.mark.parametrize("kind,early_stop", CASES)
def test_composite_pixels_matches_ref(kind, early_stop):
    """Same forward bit for bit (the same scan); gradients within 1e-5 of
    each tensor's largest entry. N = 45 leaves a short last chunk of 8."""
    offset = 0.5 if kind == "conic" else 0.0
    xs, ys = _pixels(offset=offset)
    feats, colors, valid = _feats(kind, 45, 5)
    rng = np.random.default_rng(6)
    g = (rng.normal(size=(P, 3)).astype(np.float32),
         rng.normal(size=P).astype(np.float32))
    alpha_fn = _alpha_fns(kind)[1]
    a = _run(tr.composite_pixels, xs, ys, feats, colors, valid, alpha_fn,
             early_stop, g)
    b = _run(tr.composite_pixels_ref, xs, ys, feats, colors, valid, alpha_fn,
             early_stop, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert _rel(y, x) <= 1e-5


@pytest.mark.parametrize("kind,early_stop", CASES)
def test_composite_pixels_matches_jax_vjp(kind, early_stop):
    """The port's Function against the JAX custom VJP
    (``_make_compositor``): values 1e-6, gradients 1e-4 of the largest."""
    offset = 0.5 if kind == "conic" else 0.0
    xs, ys = _pixels(offset=offset)
    feats, colors, valid = _feats(kind, 45, 7)
    rng = np.random.default_rng(8)
    g = (rng.normal(size=(P, 3)).astype(np.float32),
         rng.normal(size=P).astype(np.float32))
    j_alpha, t_alpha = _alpha_fns(kind)

    def jloss(f, c):
        rgb, alpha = jr.composite_pixels(
            jnp.asarray(xs), jnp.asarray(ys), f, c, jnp.asarray(valid),
            j_alpha, chunk=8, early_stop=early_stop)
        return (rgb * g[0]).sum() + (alpha * g[1]).sum(), (rgb, alpha)

    (jf, jc), (jrgb, jalpha) = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        tuple(map(jnp.asarray, feats)), jnp.asarray(colors))
    rgb, alpha, grads = _run(tr.composite_pixels, xs, ys, feats, colors,
                             valid, t_alpha, early_stop, g)
    assert np.abs(np.asarray(jrgb) - rgb.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(jalpha) - alpha.numpy()).max() <= 1e-6
    for a, b in zip(list(jf) + [jc], grads):
        assert _rel(a, b.numpy()) <= 1e-4


@pytest.mark.parametrize("kind,early_stop", CASES)
def test_composite_pixels_gradcheck(kind, early_stop):
    """float64 gradcheck of every differentiable input, the mask included,
    over 3 chunks of 2 (the last one padded). The scene keeps every pair
    away from the conic gates."""
    offset = 0.5 if kind == "conic" else 0.0
    xs, ys = (torch.from_numpy(x) for x in _pixels(np.float64, offset))
    feats, colors, valid = _feats(kind, 5, 11, np.float64)
    if kind == "conic":
        feats[2] = np.full(5, 0.6)  # alphas well below the 0.999 clamp
    alpha_fn = _alpha_fns(kind)[1]
    inputs = [torch.from_numpy(x).requires_grad_() for x in feats] + [
        torch.from_numpy(colors).requires_grad_(),
        torch.from_numpy(valid.astype(np.float64)).requires_grad_()]

    def f(*a):
        return tr.composite_pixels(xs, ys, tuple(a[:-2]), a[-2], a[-1],
                                   alpha_fn, 2, early_stop)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-7)


def test_composite_pixels_saves_inputs_and_t_bounds_only():
    """The backward keeps the inputs and the [n_chunks, P] entry
    transmittance: no [N, P] (or [chunk, P]) activation."""
    xs, ys = _pixels()
    feats, colors, valid = _feats("ellipse", 45, 5)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    f = [torch.from_numpy(x).requires_grad_() for x in feats]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        rgb, _ = tr.composite_pixels(
            torch.from_numpy(xs), torch.from_numpy(ys), tuple(f),
            torch.from_numpy(colors).requires_grad_(),
            torch.from_numpy(valid), tr._alpha_ellipse, 8, False)
    expect = [(P,), (P,), (45, 3), (45,), (6, P)] + [x.shape for x in feats]
    assert sorted(shapes) == sorted(tuple(s) for s in expect)
    rgb.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in f)


def test_composite_pixels_with_no_gaussians():
    """N = 0 (a tile capacity of min(N, 4096) = 0): nothing composites, and
    the backward returns empty gradients."""
    xs, ys = (torch.from_numpy(x) for x in _pixels())
    feats = [torch.zeros(0, 2, requires_grad=True), torch.zeros(0, 2),
             torch.zeros(0), torch.zeros(0, requires_grad=True)]
    colors = torch.zeros(0, 3, requires_grad=True)
    rgb, alpha = tr.composite_pixels(xs, ys, tuple(feats), colors,
                                     torch.zeros(0, dtype=torch.bool),
                                     tr._alpha_ellipse)
    assert rgb.shape == (P, 3) and not rgb.any() and not alpha.any()
    (rgb.sum() + alpha.sum()).backward()
    assert colors.grad.shape == (0, 3) and feats[0].grad.shape == (0, 2)
