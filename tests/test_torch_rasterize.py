"""Parity of the port's selection, instance binning and compositor with the
JAX package (its Pallas kernel in interpret mode), at the JAX tile (8, 128)
and chunk G = 64, in both compositor modes."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import select_gaussians as jselect
from pose_splatter_tpu.ops import rasterize_pallas as jp
from pose_splatter_torch.models.pose_splatter import select_gaussians as tselect
from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk

# The JAX package's ops/__init__ re-exports the function ``rasterize``
# under the module's name.
jr = importlib.import_module("pose_splatter_tpu.ops.rasterize")

torch.set_num_threads(1)

TILE = (8, 128)
G = 64
H, W = 40, 200  # 5 x 2 tiles, the right column half outside the image


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------------
# Selection: top_k tie order.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["step_up", "step_down", "exact_fit"])
def test_select_gaussians_tie_order(case):
    """vol0 = 4 x carve occupancy in {0, 1/2, 1} (the residual passthrough)
    is almost all ties; jax.lax.top_k puts the lower index first."""
    rng = np.random.default_rng(0)
    occ = rng.choice([0.0, 0.5, 1.0], size=3000, p=[0.5, 0.2, 0.3])
    vol0 = (4.0 * occ).astype(np.float32)
    min_n, max_n = {"step_up": (50, 400), "step_down": (2000, 2500),
                    "exact_fit": (100, 3000)}[case]
    a = jselect(jnp.asarray(vol0), min_n, max_n, 0.25, 0.25, 0.05)
    b = tselect(_t(vol0), min_n, max_n, 0.25, 0.25, 0.05)
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
    assert np.float32(a.mask_threshold) == b.mask_threshold.numpy()
    np.testing.assert_array_equal(np.asarray(a.probs), b.probs.numpy())


# ----------------------------------------------------------------------------
# Instance binning.
# ----------------------------------------------------------------------------

def _scene(n, seed, rmax=20.0, nan=True):
    rng = np.random.default_rng(seed)
    center = np.stack([rng.uniform(-30, W + 30, n),
                       rng.uniform(-10, H + 10, n)], -1).astype(np.float32)
    radius = rng.uniform(0.5, rmax, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.85
    if nan:
        center[3] = np.nan  # a culled projection
    return center, radius, valid


@pytest.mark.parametrize("expand,cap", [(16, None), (4, None), (16, 256)])
def test_build_and_gather_instances_exact(expand, cap):
    """dest/src/astarts/counts/overflow equal, including the span (expand 4)
    and row-capacity (cap 256) overflow paths."""
    n = 200
    origins, n_ty, n_tx = jr._tile_grid(H, W, TILE)
    T = n_ty * n_tx
    mcap = jp.instance_rows(n, T, expand, G, cap=cap or 4 * n + T * G)
    scenes = [_scene(n, s) for s in (1, 2)]
    t_center = _t(np.stack([s[0] for s in scenes]))
    t_radius = _t(np.stack([s[1] for s in scenes]))
    t_valid = _t(np.stack([s[2] for s in scenes]))
    got = tk._build_instances(t_center, t_radius, t_valid, n_ty, n_tx, TILE,
                              expand, G, mcap)
    packed = np.random.default_rng(3).normal(size=(2, n, tk.F)).astype(np.float32)
    inst = tk.gather_instances(_t(packed), got[0], got[1], mcap)
    total_overflow = 0
    for b, (c, r, v) in enumerate(scenes):
        ref = jp._build_instances(jnp.asarray(c), jnp.asarray(r), jnp.asarray(v),
                                  n_ty, n_tx, TILE, expand, G, mcap)
        for name, x, y in zip(("dest", "src", "astarts", "counts", "overflow"),
                              ref, got):
            np.testing.assert_array_equal(np.asarray(x), y[b].numpy(),
                                          err_msg=name)
        ref_inst = jp.gather_instances(jnp.asarray(packed[b]), ref[0], ref[1],
                                       mcap)
        np.testing.assert_array_equal(np.asarray(ref_inst)[:, :tk.F],
                                      inst[b].numpy())
        total_overflow += int(ref[4])
    if expand == 4 or cap is not None:
        assert total_overflow > 0
    assert tk.instance_rows(n, T, expand, G, cap) == jp.instance_rows(
        n, T, expand, G, cap)


# ----------------------------------------------------------------------------
# Compositor, both modes, against the Pallas kernel in interpret mode.
# ----------------------------------------------------------------------------

def _instances(mode, n, seed):
    rng = np.random.default_rng(seed)
    center, radius, valid = _scene(n, seed, rmax=12.0, nan=False)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if mode == "ellipse":
        scales = rng.uniform(1.0, 5.0, (n, 2)).astype(np.float32)
        theta = rng.uniform(-3, 3, n).astype(np.float32)
        opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
        packed = jp.pack_ellipse(jnp.asarray(center), jnp.asarray(scales),
                                 jnp.asarray(theta), jnp.asarray(opac),
                                 jnp.asarray(colors), jnp.asarray(radius))
    else:
        # Many wide, nearly opaque Gaussians: tiles hold several chunks and
        # reach the T < 1e-4 stop part way through their segments.
        radius = rng.uniform(10.0, 25.0, n).astype(np.float32)
        L = rng.normal(0, 0.3, (n, 2, 2)) + np.eye(2) * 0.6
        cov_inv = np.einsum("nij,nkj->nik", L, L) * 0.03
        conic = np.stack([cov_inv[:, 0, 0], cov_inv[:, 0, 1],
                          cov_inv[:, 1, 1]], -1).astype(np.float32)
        opac = rng.uniform(0.9, 0.99, n).astype(np.float32)
        packed = jp.pack_conic(jnp.asarray(center), jnp.asarray(conic),
                               jnp.asarray(opac), jnp.asarray(colors),
                               jnp.asarray(radius))
    origins, n_ty, n_tx = jr._tile_grid(H, W, TILE)
    T = n_ty * n_tx
    mcap = jp.instance_rows(n, T, 16, G)
    dest, src, astarts, counts, _ = jp._build_instances(
        jnp.asarray(center), jnp.asarray(radius), jnp.asarray(valid),
        n_ty, n_tx, TILE, 16, G, mcap)
    packed = jnp.where(jnp.asarray(valid)[:, None], packed, 0.0)
    inst = jp.gather_instances(packed, dest, src, mcap)  # [mcap, 128]
    return inst, astarts, counts, origins.astype(jnp.int32)


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
def test_compositor_matches_pallas(mode):
    early_stop = mode == "conic"
    offset = 0.5 if mode == "conic" else 0.0
    inst, astarts, counts, origins = _instances(
        mode, 250 if mode == "ellipse" else 1500, 4)
    with pltpu.force_tpu_interpret_mode():
        rgb, alpha, jstop, _ = jp._forward_call(
            inst.reshape(-1, G, jp.FS), astarts, counts, origins, mode=mode,
            tile_shape=TILE, early_stop=early_stop, pixel_offset=offset, G=G)
    t_inst = _t(np.asarray(inst)[:, :tk.F])
    args = (_t(np.asarray(astarts)), _t(np.asarray(counts)),
            _t(np.asarray(origins)), TILE, G, mode)
    got = tk.composite_instances(t_inst, *args)
    ref_plain = tk.composite_instances_ref(t_inst, *args)
    for x, y in zip(got, ref_plain):  # the CPU wrapper runs the plain version
        assert torch.equal(x, y)
    # Transmittance products in sequential (port) against doubling-scan
    # (Pallas) order: float32 rounding only.
    np.testing.assert_allclose(np.asarray(rgb), got[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(alpha), got[1].numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jstop), got[2].numpy())
    n_steps = (np.asarray(counts) + G - 1) // G
    if early_stop:
        assert (got[2].numpy() < n_steps).any()  # some tile stopped early
    else:
        np.testing.assert_array_equal(got[2].numpy(), n_steps)
    assert float(got[1].max()) > 0.5
    assert tk.composite_instances.launches == 0  # no kernel on the CPU


def test_compositor_rejects_unknown_mode_and_device():
    inst = torch.zeros((G, tk.F))
    z = torch.zeros((1,), dtype=torch.int32)
    o = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.composite_instances(inst, z, z, o, TILE, G, "disk")
    with pytest.raises(ValueError):
        tk.composite_instances(inst.to("meta"), z, z, o, TILE, G, "ellipse")


# ----------------------------------------------------------------------------
# rasterize_2d end to end.
# ----------------------------------------------------------------------------

def _gaussians_2d(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        means2d=np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)],
                         -1).astype(np.float32),
        scales2d=rng.uniform(0.8, 4.0, (n, 2)).astype(np.float32),
        rotations=rng.normal(0, 1, n).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("mode,expand", [("global", None), ("kernel", 16),
                                         ("kernel", 2)])
def test_rasterize_2d_matches(mode, expand):
    g = _gaussians_2d(180, 5)
    valid = np.random.default_rng(6).uniform(size=180) < 0.9
    bg = np.array([1.0, 0.9, 0.8], np.float32)
    jmode = "pallas" if mode == "kernel" else "global"
    with pltpu.force_tpu_interpret_mode():
        ref = jr.rasterize_2d(
            *[jnp.asarray(g[k]) for k in g], W, H, valid=jnp.asarray(valid),
            background=jnp.asarray(bg), mode=jmode, tile_expand=expand,
            return_overflow=True)
    got = tr.rasterize_2d(*[_t(g[k]) for k in g], W, H, valid=_t(valid),
                          background=_t(bg), mode=mode, tile_expand=expand,
                          return_overflow=True)
    np.testing.assert_allclose(np.asarray(ref[0]), got[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref[1]), got[1].numpy(), atol=1e-5)
    assert int(ref[2]) == int(got[2])
    if expand == 2:
        assert int(got[2]) > 0  # truncated spans are counted


def test_tile_shape_changes_the_2d_image():
    """Trap: an ellipse instance is evaluated on every pixel of each tile its
    3σ circle touches, with no cutoff inside the tile, so pixels beyond 3σ
    get a contribution in some tiles and none in others. The tile shape is
    part of the 2D image: the port keeps the JAX package's (8, 128) default
    (held in ``test_rasterize_2d_matches``) and matches it at another tile
    shape too."""
    assert tr.DEFAULT_TILE == jr.DEFAULT_TILE_PALLAS == TILE
    g = _gaussians_2d(80, 5)
    with pltpu.force_tpu_interpret_mode():
        ref = jr.rasterize_2d(*[jnp.asarray(g[k]) for k in g], W, H,
                              mode="pallas", tile_shape=(8, 64), tile_expand=64,
                              return_overflow=True)
    targs = [_t(g[k]) for k in g]
    narrow = tr.rasterize_2d(*targs, W, H, mode="kernel", tile_shape=(8, 64),
                             tile_expand=64, return_overflow=True)
    wide = tr.rasterize_2d(*targs, W, H, mode="kernel", tile_expand=64,
                           return_overflow=True)
    assert int(ref[2]) == int(narrow[2]) == int(wide[2]) == 0
    np.testing.assert_allclose(np.asarray(ref[0]), narrow[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref[1]), narrow[1].numpy(), atol=1e-5)
    assert float((wide[1] - narrow[1]).abs().max()) > 1e-4


def test_rasterize_2d_batched_views_equal_single_views():
    """Views folded into one tile axis render what separate calls render."""
    g = _gaussians_2d(120, 7)
    shift = np.array([[0.0, 0.0], [3.3, -2.1], [-7.5, 4.0]], np.float32)
    means = _t(g["means2d"][None] + shift[:, None])
    rest = [_t(g[k]) for k in ("scales2d", "rotations", "opacities", "colors")]
    rgb, alpha, ov = tr.rasterize_2d(means, *rest, W, H, mode="kernel",
                                     tile_expand=16, return_overflow=True)
    assert rgb.shape == (3, H, W, 3)
    total = 0
    for b in range(3):
        r1, a1, o1 = tr.rasterize_2d(means[b], *rest, W, H, mode="kernel",
                                     tile_expand=16, return_overflow=True)
        assert torch.equal(r1, rgb[b]) and torch.equal(a1, alpha[b])
        total += int(o1)
    assert total == int(ov)
