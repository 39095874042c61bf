"""The port's backward compositor, the forward's ``tbounds`` store, the
instance gather's backward and the 2D rasterizer's gradients against the
JAX package (its Pallas kernels in interpret mode), at the JAX tile
(8, 128) and chunk G = 64 (the first 16 of its 128 columns), in both
compositor modes."""

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
from test_torch_rasterize import G, TILE, _instances, _scene, _t, H, W

jr = importlib.import_module("pose_splatter_tpu.ops.rasterize")

torch.set_num_threads(1)


def _grads_out(nt, seed):
    """Seeded loss gradients of rgb [T,3,P] and alpha [T,P]."""
    rng = np.random.default_rng(seed)
    P = TILE[0] * TILE[1]
    return (rng.normal(0, 1, (nt, 3, P)).astype(np.float32),
            rng.normal(0, 1, (nt, P)).astype(np.float32))


def _assert_grads_close(ref, got, rel):
    """Within ``rel`` of the largest gradient of each column (of the whole
    array if it is 1-D): both sides sum over 1,024 pixels a row and carry a
    suffix over up to 12 chunks in another order (a doubling scan on the
    TPU side), so float32 rounding grows with the sums, not with each
    entry. The conic d(A, B, C) columns sum terms up to dx² ≈ 1.6e4 times
    dsigma that largely cancel, so their entries are far below their
    terms."""
    scale = np.abs(ref).max(axis=0) if ref.ndim == 2 else np.abs(ref).max()
    assert np.max(scale) > 0
    assert (np.abs(ref - got) <= rel * scale).all(), (
        np.abs(ref - got).max(axis=0) / np.maximum(scale, 1e-30))


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
def test_backward_and_tbounds_match_pallas(mode):
    early_stop = mode == "conic"
    offset = 0.5 if mode == "conic" else 0.0
    inst, astarts, counts, origins = _instances(
        mode, 250 if mode == "ellipse" else 1500, 4)
    nt = int(astarts.shape[0])
    g_rgb, g_alpha = _grads_out(nt, 9)
    inst3 = inst.reshape(-1, G, jp.FS)
    compose = jp._make_compositor(mode, TILE, early_stop, offset, G)
    with pltpu.force_tpu_interpret_mode():
        _, _, jjstop, jtb = jp._forward_call(
            inst3, astarts, counts, origins, mode=mode, tile_shape=TILE,
            early_stop=early_stop, pixel_offset=offset, G=G, save_tbounds=True)
        _, vjp = jax.vjp(lambda i: compose(i, astarts, counts, origins), inst3)
        (jd,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_alpha)))
    t_inst = _t(np.asarray(inst)[:, :tk.F])
    args = (_t(np.asarray(astarts)), _t(np.asarray(counts)),
            _t(np.asarray(origins)))
    rgb, alpha, jstop, tbounds = tk.composite_instances(
        t_inst, *args, TILE, G, mode, save_tbounds=True)
    np.testing.assert_array_equal(np.asarray(jjstop), jstop.numpy())
    n_steps = (np.asarray(counts) + G - 1) // G
    if early_stop:
        assert (jstop.numpy() < n_steps).any()  # the store stops with the walk
    # tbounds: each walked chunk's entry T (JAX leaves the rest unwritten,
    # the port zero). Products in sequential against doubling-scan order.
    walked = np.zeros(tbounds.shape[0], bool)
    for a, j in zip(np.asarray(astarts) // G, jstop.numpy()):
        walked[a:a + j] = True
    np.testing.assert_allclose(np.asarray(jtb)[walked, 0], tbounds.numpy()[walked],
                               rtol=0, atol=1e-6)
    assert (tbounds.numpy()[~walked] == 0).all()

    dinst = tk.composite_instances_bwd(t_inst, tbounds, *args, jstop,
                                       _t(g_rgb), _t(g_alpha), TILE, G, mode)
    ref = np.asarray(jd).reshape(-1, jp.FS)
    _assert_grads_close(ref[:, :tk.F], dinst.numpy(), 5e-5)
    assert (dinst[:, 10:] == 0).all()
    if mode == "conic":
        assert (dinst[:, 5] == 0).all()
    assert float(dinst.abs().max()) > 0
    assert tk.composite_instances_bwd.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
def test_backward_ref_matches_autograd_of_forward(mode):
    """The hand-derived reverse walk equals autograd through the plain
    forward's chunked cumprod scan."""
    inst, astarts, counts, origins = _instances(
        mode, 250 if mode == "ellipse" else 1500, 5)
    t_inst = _t(np.asarray(inst)[:, :tk.F]).requires_grad_(True)
    args = (_t(np.asarray(astarts)), _t(np.asarray(counts)),
            _t(np.asarray(origins)), TILE, G, mode)
    g_rgb, g_alpha = (_t(x) for x in _grads_out(int(astarts.shape[0]), 3))
    rgb, alpha, _ = tk.composite_instances_ref(t_inst, *args)
    ((rgb * g_rgb).sum() + (alpha * g_alpha).sum()).backward()
    with torch.no_grad():
        _, _, jstop, tbounds = tk.composite_instances_ref(
            t_inst, *args, save_tbounds=True)
        dinst = tk.composite_instances_bwd_ref(t_inst, tbounds, *args[:3],
                                               jstop, g_rgb, g_alpha, *args[3:])
    # Autograd divides by nothing either, but sums its cumprod backward in
    # another order (tolerance as above).
    _assert_grads_close(t_inst.grad.numpy(), dinst.numpy(), 5e-5)


def test_composite_with_grad_stores_only_for_a_gradient(monkeypatch):
    inst, astarts, counts, origins = _instances("ellipse", 120, 6)
    t_inst = _t(np.asarray(inst)[:, :tk.F])
    args = (_t(np.asarray(astarts)), _t(np.asarray(counts)),
            _t(np.asarray(origins)), TILE, G, "ellipse")
    seen = []
    fwd = tk.composite_instances_ref

    def spy(*a, **k):
        seen.append(a[7] if len(a) > 7 else k.get("save_tbounds", False))
        return fwd(*a, **k)

    monkeypatch.setattr(tk, "composite_instances_ref", spy)
    plain = tk.composite_with_grad(t_inst, *args)
    with_grad = tk.composite_with_grad(t_inst.clone().requires_grad_(True), *args)
    assert seen == [False, True]
    assert torch.equal(plain[0], with_grad[0]) and torch.equal(plain[1], with_grad[1])


def test_gather_instances_backward_matches_jax():
    """Gather-reduce backward: dpacked[n] = Σ_e dinst[dest[n, e]], dead and
    dropped slots reading a zero row (cap 256 drops whole tile tails)."""
    n = 200
    origins, n_ty, n_tx = jr._tile_grid(H, W, TILE)
    T = n_ty * n_tx
    mcap = jp.instance_rows(n, T, 16, G, cap=256)
    c, r, v = _scene(n, 1)
    ref = jp._build_instances(jnp.asarray(c), jnp.asarray(r), jnp.asarray(v),
                              n_ty, n_tx, TILE, 16, G, mcap)
    assert int(ref[4]) > 0
    rng = np.random.default_rng(2)
    packed = rng.normal(size=(n, tk.F)).astype(np.float32)
    dinst = rng.normal(size=(mcap, jp.FS)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jp.gather_instances(p, ref[0], ref[1], mcap),
                     jnp.asarray(packed))
    (jd,) = vjp(jnp.asarray(dinst))
    tp = _t(packed)[None].requires_grad_(True)
    dest, src = (_t(np.asarray(x)).long()[None] for x in ref[:2])
    out = tk.gather_instances(tp, dest, src, mcap)
    out.backward(_t(dinst[:, :tk.F])[None])
    # Sums of up to 16 slots in another order.
    np.testing.assert_allclose(np.asarray(jd), tp.grad[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["kernel", "global"])
def test_rasterize_2d_gradients_match_jax(mode):
    """Autograd through pack, gather, composite, untile and background (and
    through the global oracle's scan) equals JAX's gradients."""
    rng = np.random.default_rng(8)
    n = 120
    g = dict(
        means2d=np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)],
                         -1).astype(np.float32),
        scales2d=rng.uniform(0.8, 4.0, (n, 2)).astype(np.float32),
        rotations=rng.normal(0, 1, n).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )
    valid = rng.uniform(size=n) < 0.9
    bg = np.array([1.0, 0.9, 0.8], np.float32)
    w_rgb = rng.normal(size=(H, W, 3)).astype(np.float32)
    w_alpha = rng.normal(size=(H, W)).astype(np.float32)
    jmode = "pallas" if mode == "kernel" else "global"

    def jloss(*xs):
        rgb, alpha = jr.rasterize_2d(*xs, W, H, valid=jnp.asarray(valid),
                                     background=jnp.asarray(bg), mode=jmode,
                                     tile_expand=16)
        return (rgb * w_rgb).sum() + (alpha * w_alpha).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=tuple(range(5)))(
            *[jnp.asarray(g[k]) for k in g])
    xs = [_t(g[k]).requires_grad_(True) for k in g]
    rgb, alpha = tr.rasterize_2d(*xs, W, H, valid=_t(valid), background=_t(bg),
                                 mode=mode, tile_expand=16)
    ((rgb * _t(w_rgb)).sum() + (alpha * _t(w_alpha)).sum()).backward()
    for name, r, x in zip(g, ref, xs):
        _assert_grads_close(np.asarray(r), x.grad.numpy(), 2e-5)
    assert float(xs[0].grad.abs().max()) > 0
