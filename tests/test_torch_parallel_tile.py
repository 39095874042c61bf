"""The port's tile-sharded render and strip-halo SSIM
(``parallel/tile_sharding.py``) in 4 gloo ranks on one ``tile`` axis,
against the JAX functions on a 4-device sub-mesh of the virtual CPU mesh
and the unsharded renders, on ``tests/test_sharding.py``'s scenes.

- ``rasterize_tile_sharded``: 3 cameras on a 64x72 image, whose 9 rows of
  (8, 64) tiles do not divide over 4 ranks (padding), backgrounds on; the
  port's ``"tiled"`` and ``"kernel"`` compositors (the JAX ``"xla"`` and
  ``"pallas"``, the latter under ``pltpu.force_tpu_interpret_mode()``; the
  port's kernel runs its plain version on the CPU) against both JAX
  compositors and the unsharded ``rasterize(mode="tiled")`` of both
  packages, within 1e-5; one gradient through it (of sum(rgb²) in the
  opacities), the same on every rank, within 1e-3 of JAX's largest entry.
- ``_ssim_band_partial`` with (2, 16) tiles: a band of 6 rows, shorter
  than the 10-row halo, so the halo takes two hops; the partials of each
  rank equal JAX's within 1e-6, and their sums give ``ops/ssim.ssim``.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_worker as TW
from pose_splatter_tpu.ops.rasterize import rasterize as jrasterize
from pose_splatter_tpu.parallel.tile_sharding import (
    _ssim_band_partial as jband,
    rasterize_tile_sharded as jtile,
    shard_map,
)
from pose_splatter_torch.ops.rasterize import rasterize
from pose_splatter_torch.ops.ssim import ssim
from pose_splatter_torch.parallel.launch import launch

torch.set_num_threads(1)

RANKS = 4
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
SSIM_TILE = (2, 16)


def _inputs():
    means, quats, scales, opac, colors = TW.scene()
    K = np.array([[100.0, 0, 32.0], [0, 100.0, 36.0], [0, 0, 1]], np.float32)
    views = np.stack([np.eye(4, dtype=np.float32)] * 3)
    views[1, 0, 3], views[2, 1, 3] = 0.05, -0.05
    rng = np.random.default_rng(1)
    n = 20
    g = dict(
        g_means=(rng.normal(0, 0.2, (n, 3)) + [0, 0, 2.0]).astype(np.float32),
        g_quats=rng.normal(size=(n, 4)).astype(np.float32),
        g_scales=np.full((n, 3), 0.05, np.float32),
        g_opac=rng.uniform(0.3, 0.9, n).astype(np.float32),
        g_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        g_view=np.eye(4, dtype=np.float32),
        g_K=np.array([[100.0, 0, 32.0], [0, 100.0, 32.0], [0, 0, 1]],
                     np.float32))
    srng = np.random.default_rng(2)
    tgt = srng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    pred = np.clip(tgt + srng.normal(0, 0.1, tgt.shape), 0, 1).astype(np.float32)
    return dict(means=means, quats=quats, scales=scales, opac=opac,
                colors=colors, Ks=np.stack([K] * 3), views=views,
                ssim_pred=pred, ssim_tgt=tgt, **g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tile")
    inp = _inputs()
    np.savez(d / "tile_inputs.npz", **inp)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    g = (j["means"], j["quats"], j["scales"], j["opac"], j["colors"])
    with ThreadPoolExecutor(1) as ex:
        ranks_done = ex.submit(launch, RANKS, [WORKER, "tile", str(d)],
                               timeout=300)
        mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("tile",))
        kw = dict(tile_shape=(8, 64), tile_capacity=64,
                  backgrounds=jnp.ones(3))
        out = {}
        out["xla"] = jtile(*g, j["views"], j["Ks"], 64, 72, mesh,
                           compositor="xla", **kw)
        with pltpu.force_tpu_interpret_mode():
            out["pallas"] = jtile(*g, j["views"], j["Ks"], 64, 72, mesh,
                                  compositor="pallas", **kw)
        out["jax_unsharded"] = jrasterize(
            *g, j["views"], j["Ks"], 64, 72, mode="tiled", **kw)
        t = {k: torch.as_tensor(v) for k, v in inp.items()}
        out["port_unsharded"] = rasterize(
            t["means"], t["quats"], t["scales"], t["opac"], t["colors"],
            t["views"], t["Ks"], 64, 72, mode="tiled", tile_shape=(8, 64),
            tile_capacity=64, backgrounds=torch.ones(3))

        def loss(opac):
            rgb, _ = jtile(j["g_means"], j["g_quats"], j["g_scales"], opac,
                           j["g_colors"], j["g_view"], j["g_K"], 64, 64, mesh,
                           tile_shape=(8, 64), tile_capacity=32)
            return (rgb ** 2).sum()

        out["grad"] = jax.grad(loss)(j["g_opac"])

        n_tx = -(-40 // SSIM_TILE[1])
        strips = [jnp.asarray(TW.strip_tiles(inp[k], SSIM_TILE, RANKS))
                  for k in ("ssim_pred", "ssim_tgt")]

        def band(p, t):
            s, c = jband(p, t, "tile", n_tx, *SSIM_TILE, 24, 40)
            return s[None], c[None]

        out["band"] = shard_map(band, mesh=mesh,
                                in_specs=(P(None, "tile"), P(None, "tile")),
                                out_specs=(P("tile"), P("tile")),
                                check_rep=False)(*strips)
        ranks_done.result()
    out = jax.tree.map(np.asarray, out,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]
    return inp, out, ranks


@pytest.mark.parametrize("comp", ["tiled", "kernel"])
def test_tile_sharded_render_matches(run, comp):
    """Every rank returns the whole image, equal to JAX's sharded render
    in both compositors and to both packages' unsharded tiled render."""
    inp, out, ranks = run
    for r in ranks:
        np.testing.assert_array_equal(r[f"{comp}.rgb"], ranks[0][f"{comp}.rgb"])
    rgb, alpha = ranks[0][f"{comp}.rgb"], ranks[0][f"{comp}.alpha"]
    assert rgb.shape == (3, 72, 64, 3)
    assert alpha.max() > 0.5
    for ref in ("xla", "pallas", "jax_unsharded"):
        np.testing.assert_allclose(rgb, np.asarray(out[ref][0]), atol=1e-5,
                                   err_msg=ref)
        np.testing.assert_allclose(alpha, np.asarray(out[ref][1]), atol=1e-5,
                                   err_msg=ref)
    prgb, palpha = out["port_unsharded"]
    np.testing.assert_allclose(rgb, prgb, atol=1e-5)
    np.testing.assert_allclose(alpha, palpha, atol=1e-5)


@pytest.mark.parametrize("comp", ["tiled", "kernel"])
def test_tile_sharded_gradient(run, comp):
    """The opacities' gradient through the 4 ranks' tiles is finite, not
    zero, the same on every rank and within 1e-3 of JAX's largest entry."""
    _, out, ranks = run
    g = ranks[0][f"{comp}.grad"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{comp}.grad"], g)
    ref = np.asarray(out["grad"])
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_ssim_band_partials_multi_hop(run):
    """Each rank's (sum, count) equals JAX's within 1e-6, and the summed
    partials over the summed counts equal the whole-image SSIM."""
    inp, out, ranks = run
    jsum, jcnt = out["band"]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["ssim.sum"], jsum[r], rtol=1e-6,
                                   atol=1e-6)
        assert float(rank["ssim.count"]) == float(jcnt[r])
    total = sum(float(r["ssim.sum"]) for r in ranks)
    count = sum(float(r["ssim.count"]) for r in ranks)
    assert count == 2 * 3 * (24 - 10) * (40 - 10)
    whole = float(ssim(torch.as_tensor(inp["ssim_pred"]),
                       torch.as_tensor(inp["ssim_tgt"])))
    assert total / count == pytest.approx(whole, abs=1e-6)
