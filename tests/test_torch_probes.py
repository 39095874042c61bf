"""The stage-attribution probes (``pose_splatter_torch/scripts/
bench_breakdown.py``, ``dbg_*``) on the CPU at small sizes: each ``main``
returns every line its JAX script prints, raises where no GPU is present
unless asked for the CPU, and the functions a probe times are held
against the JAX package function they stand for or against a jnp
transcription of the JAX script's lines (cited at each). The JAX scripts
do their work at import, at full size, so they are never imported
here."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pose_splatter_tpu.ops.rasterize  # noqa: F401
import pose_splatter_tpu.ops.rasterize_pallas  # noqa: F401
from pose_splatter_tpu.ops import carving as jc
from pose_splatter_tpu.ops.projection import project_gaussians
from pose_splatter_tpu.utils import cameras as jcam
from pose_splatter_torch.ops import carving as tc
from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.scripts import bench
from pose_splatter_torch.scripts import dbg_bin_micro as bin_micro
from pose_splatter_torch.scripts import dbg_carve_micro as carve_micro
from pose_splatter_torch.scripts import dbg_gather_bwd as gather_bwd
from pose_splatter_torch.scripts import dbg_model_breakdown as model_bd
from pose_splatter_torch.scripts import dbg_vmap_kernel as vmap_kernel
from pose_splatter_torch.scripts import probe_common as pc

torch.set_num_threads(1)

# The modules (``pose_splatter_tpu.ops`` binds ``rasterize`` to the
# function of that name).
jr = sys.modules["pose_splatter_tpu.ops.rasterize"]
jrp = sys.modules["pose_splatter_tpu.ops.rasterize_pallas"]

RAST = ["--height", "32", "--width", "48", "--n", "200"]
MODEL = ["--width", "48", "--height", "32", "--grid", "32", "--crop",
         "0,16,0,16,8,24", "--min-n", "16", "--max-n", "128"]

# argv at a small size, and the lines of the JAX script (its labels).
PROBES = {
    "bench_breakdown": (RAST, [
        "project+sort", "+bin+compose fwd", "compose fwd", "compose fwd+bwd",
        "full fwd", "full fwd+bwd"]),
    "dbg_rast_breakdown": (RAST, [
        "full fwd", "full fwd+bwd", "proj+sort+pack", "bin only",
        "gather fwd", "gather fwd+bwd", "kernel fwd", "kernel fwd+bwd"]),
    "dbg_kernel_profile": (["64", "8", "128", "full"] + RAST, [
        "bin", "gather inst", "gather inst bwd", "kernel fwd",
        "kernel fwd empty", "kernel fwd+bwd", "full fwd", "fwd+bwd means",
        "fwd+bwd opac", "fwd+bwd colors", "fwd+bwd all"]),
    "dbg_gather_bwd": (["--n", "300", "--mcap", "2048"], [
        "bwd current (16-lane gather)", "bwd full-row gather + slice",
        "fwd gather_instances", "sort_key_val [N*E]", "invert_slots"]),
    "dbg_bin_micro": (["--n", "400", "--tiles", "20", "--mcap", "2048"], [
        "sort_key_val 256k", "searchsorted 74k in 256k",
        "scatter-set 256k scalars", "scatter-set 256k rows x128",
        "gather 74k rows x128", "slot rank by stable sort [256k]",
        "take_along_axis [N,16]", "elementwise [N,T] rect test",
        "argsort 16k f32", "sort_key_val 64k"]),
    "dbg_carve_micro": (["--voxels", "6000", "--height", "24", "--width",
                         "32"], [
        "lexsort+restore visibility (1 thr)",
        "shared-sort + scan + scatter (1 thr)",
        "scatter-min visibility (1 thr)", "sample gather [C,N,3]",
        "sample gather [C,N,1] (mask)", "sample gather 128-lane padded",
        "projection einsum [C,N,3]", "paired vis (BOTH thresholds)",
        "sample gather [C,N,4] fused", "current vis x2 thresholds"]),
    "dbg_model_breakdown": (MODEL, [
        "carve", "carve+unets", "carve+unets+heads", "full fwd (eval)",
        "train step (fwd+bwd+adam)", "grad: carve+unets",
        "grad: thru render", "grad: full loss (ssim)"]),
    "dbg_step_bisect": (["all"] + MODEL, [
        "full step", "no ssim", "ablation (no unets)", "1 unet"]),
    "dbg_dispatch_floor": ([], [
        "tiny matmul", "tiny chain x10", "2048 matmul"]),
}


def _module(name):
    return importlib.import_module(f"pose_splatter_torch.scripts.{name}")


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_main_returns_every_line(name, capsys):
    argv, lines = PROBES[name]
    out = _module(name).main(argv + ["--device", "cpu", "--iters", "1"])
    assert list(out["lines"]) == lines
    assert all(np.isfinite(v) and v > 0 for v in out["lines"].values())
    assert out["card"] == "cpu" and out["device"] == "cpu"
    printed = capsys.readouterr().out
    for line in lines:
        assert f"{line}" in printed
    if name == "dbg_gather_bwd":
        assert out["allclose"] and "allclose: True" in printed
    if name == "dbg_carve_micro":
        assert all(out["agree"].values()) and out["visible"] > 0
    if name == "dbg_rast_breakdown":
        assert out["overflow"] == 0 and out["total_inst"] > 0
        assert "counts: total inst=" in printed and "tiles=4 mcap=" in printed
    if name == "dbg_kernel_profile":
        assert "T=4 tiles, P=1024, mcap=" in printed
        assert "total instances:" in printed and out["chunk_steps"] > 0


@pytest.mark.parametrize("name", sorted(PROBES) + ["dbg_vmap_kernel"])
def test_probe_raises_without_a_gpu_unless_asked(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).main([])


@pytest.mark.parametrize("argv", [["64", "64", "32"], ["1024", "8", "128"],
                                  ["600", "8", "128"]])
@pytest.mark.parametrize("name", ["bench_breakdown", "dbg_kernel_profile"])
def test_kernel_limits_raise_on_every_device(name, argv):
    """Tiles over 1024 pixels, chunks over 512 rows (the backward's
    limit): the message the kernels raise with, before anything runs."""
    with pytest.raises(ValueError, match="not supported"):
        _module(name).main(argv + ["--device", "cpu", "--n", "10"])


# ---- the rasterizer probes' functions against the JAX package ---------

def test_bench_scene_stages_match_jax():
    """``project_sorted`` (the scripts' ``stage_proj``) in the same order,
    and the kernel-mode ``rasterize`` (the "full" lines) against the JAX
    ``rasterize`` in ``"pallas"`` mode (interpret) within 1e-5."""
    H, W, N = 32, 48, 200
    scene = bench.scene_3d(1, H, W, N)
    mean2d, conic, rad, ok, opac, cols = pc.project_sorted(
        [torch.from_numpy(a) for a in scene], H, W)
    means, quats, scales, jopac, jcols, view, Ks = map(jnp.asarray, scene)
    proj = jax.vmap(lambda v, k: project_gaussians(
        means, quats, scales, v, k, W, H))(view, Ks)
    order = np.asarray(jnp.argsort(jnp.where(proj.valid, proj.depth,
                                             jnp.inf)[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(proj.valid[0])[order])
    np.testing.assert_allclose(opac.numpy(), scene[3][order], rtol=0, atol=0)
    np.testing.assert_allclose(mean2d.numpy()[ok.numpy()],
                               np.asarray(proj.mean2d[0])[order][ok.numpy()],
                               rtol=1e-6, atol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        ref = jr.rasterize(means, quats, scales, jopac, jcols, view, Ks, W, H,
                           backgrounds=jnp.ones(3), mode="pallas")
    got = tr.rasterize(*[torch.from_numpy(a) for a in scene], W, H,
                       backgrounds=torch.ones(3), mode="kernel")
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)
    assert float(got[1].max()) > 0.5


# ---- dbg_gather_bwd ---------------------------------------------------

def test_gather_bwd_forms_match_the_scripts_lines():
    """``bwd_current`` / ``bwd_fullrow`` against ``dbg_gather_bwd.py:35-49``
    in jnp at FS = 128 and the port's F = 16, and at F = 16 against
    ``gather_instances``' own backward."""
    n, e, mcap = 300, 16, 2048
    for fs in (128, 16):  # the last, the port's F, for gather_instances
        dest, dinst, packed, src = gather_bwd.inputs("cpu", n, e, mcap, fs)
        jd, jdi = jnp.asarray(dest.numpy()), jnp.asarray(dinst.numpy())
        live = jd < mcap
        rows = jnp.where(live, jd, 0)
        ref_cur = jnp.where(live[:, None], jdi[rows, :16], 0.0).reshape(
            n, -1, 16).sum(axis=1)
        dpad = jnp.concatenate([jdi, jnp.zeros((1, fs), jdi.dtype)], axis=0)
        ref_full = jnp.take(dpad, jnp.where(live, jd, mcap), axis=0).reshape(
            n, -1, fs).sum(axis=1)[:, :16]
        cur = gather_bwd.bwd_current(dinst, dest, n, mcap)
        full = gather_bwd.bwd_fullrow(dinst, dest, n, mcap)
        np.testing.assert_allclose(cur.numpy(), np.asarray(ref_cur), atol=1e-5)
        np.testing.assert_allclose(full.numpy(), np.asarray(ref_full),
                                   atol=1e-5)
        np.testing.assert_allclose(cur.numpy(), full.numpy(), atol=1e-5)
    p = packed[None].clone().requires_grad_()
    out = K.gather_instances(p, dest[None], src[None], mcap)
    (g,) = torch.autograd.grad(out, p, dinst[None])
    np.testing.assert_allclose(g[0].numpy(), full.numpy(), atol=1e-5)


# ---- dbg_bin_micro ----------------------------------------------------

def test_bin_micro_functions_match_jax():
    n, e, t, mcap = 500, 16, 40, 4096
    rng = np.random.default_rng(4)
    # Each Gaussian's slots on distinct tiles, so its one-hot row holds
    # them: the slot rank is the exclusive cumsum read at its tile.
    tile = np.stack([rng.permutation(t)[:e] for _ in range(n)])
    oh = np.zeros((n, t), np.float32)
    np.put_along_axis(oh, tile, 1.0, axis=1)
    excl, _ = jrp._excl_cumsum_mxu(jnp.asarray(oh))
    ref_rank = np.take_along_axis(np.asarray(excl), tile, 1)
    flat = torch.from_numpy(tile.reshape(-1))
    rank = K._slot_rank(flat, torch.bincount(flat, minlength=t))
    np.testing.assert_array_equal(rank.reshape(n, e).numpy(), ref_rank)
    np.testing.assert_array_equal(
        bin_micro.excl_cumsum(torch.from_numpy(oh)).numpy(), np.asarray(excl))
    # The slot inversion and the row scatter, unique live rows.
    k = n * e
    live = rng.uniform(size=k) < 0.3
    dest = np.where(live, rng.permutation(mcap + k)[:k] % (2 * mcap),
                    mcap + np.arange(k))
    dest = np.where(live & (dest < mcap), dest, mcap + np.arange(k))
    src = rng.integers(0, n, k)
    ref_inv, _ = jrp._invert_slots(jnp.asarray(dest, jnp.int32),
                                   jnp.asarray(src, jnp.int32), n, mcap)
    inv = K._invert_slots(torch.from_numpy(dest)[None],
                          torch.from_numpy(src)[None], n, mcap)[0]
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ref_inv))
    packed = rng.normal(size=(n, 128)).astype(np.float32)
    ref_rows = jnp.zeros((mcap, 128), jnp.float32).at[jnp.asarray(dest)].set(
        jnp.asarray(packed)[jnp.asarray(src)], mode="drop",
        unique_indices=True)
    rows = bin_micro.scatter_rows(torch.from_numpy(dest),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(src), mcap)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    # Item 8 (dbg_bin_micro.py:81-85).
    cx = rng.uniform(0, 576, n).astype(np.float32)
    tty = (jnp.arange(t, dtype=jnp.int32) // 4)[None, :]
    ry = tty - (jnp.asarray(cx)[:, None] // 37).astype(jnp.int32)
    ref_rect = ((ry >= 0) & (ry < 3)).astype(jnp.float32)
    np.testing.assert_array_equal(
        bin_micro.rect(torch.from_numpy(cx), t).numpy(), np.asarray(ref_rect))


# ---- dbg_carve_micro --------------------------------------------------

def test_carve_micro_variants_match_the_scripts_lines():
    """Items 1-3 and 8 against ``dbg_carve_micro.py:38-73, 100-116`` in jnp
    and the JAX ``ray_cast_visibility_pair``, exactly."""
    x = carve_micro.inputs("cpu", 8000, 3, 24, 32, seed=2)
    d, idx, occ, occ2 = x["d"], x["idx"], x["occ"], x["occ2"]
    jd, ji, jo = (jnp.asarray(v.numpy()) for v in (d, idx.int(), occ))
    n, hw = d.shape[1], 24 * 32
    iota = jnp.arange(n, dtype=jnp.int32)

    def vis_sort(dd, ii):
        masked = jnp.where(jo, dd, jnp.inf)
        p_s, d_s, i_s = jax.lax.sort((ii, masked, iota), num_keys=2)
        first = jnp.concatenate([jnp.ones((1,), bool), p_s[1:] != p_s[:-1]])
        _, vis = jax.lax.sort((i_s, (first & jnp.isfinite(d_s)).astype(
            jnp.int32)), num_keys=1)
        return vis.astype(bool)

    def vis_shared(dd, ii):
        p_s, _, i_s = jax.lax.sort((ii, dd, iota), num_keys=2)
        occ_s = jo[i_s]
        first = jnp.concatenate([jnp.ones((1,), bool), p_s[1:] != p_s[:-1]])
        excl = jnp.cumsum(occ_s.astype(jnp.int32)) - occ_s.astype(jnp.int32)
        seg_base = jax.lax.cummax(jnp.where(first, excl, -1))
        vis_s = occ_s & ((excl - seg_base) == 0)
        return jnp.zeros((n,), jnp.int32).at[i_s].set(
            vis_s.astype(jnp.int32)).astype(bool)

    def vis_scatter(dd, ii):
        masked = jnp.where(jo, dd, jnp.inf)
        front = jnp.full((hw,), jnp.inf).at[ii].min(masked)
        return (masked <= front[ii]) & jo

    for ref_fn, got in (
            (vis_sort, tc.frontmost_visible(d, idx, occ, hw, "sort")),
            (vis_shared, carve_micro.vis_shared(d, idx, occ)),
            (vis_scatter, tc.frontmost_visible(d, idx, occ, hw, "segment"))):
        ref = np.asarray(jax.vmap(ref_fn)(jd, ji))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert ref.sum() > 0
    r1, r2 = jc.ray_cast_visibility_pair(jd, ji, jo, jnp.asarray(occ2.numpy()))
    v1, v2 = tc.ray_cast_visibility_pair(d, idx, occ, occ2, hw)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(r2))
    # Items 4, 5, 7 (take_along_axis, the padded row gather, the einsum).
    imgs = x["imgs"]
    ref = np.take_along_axis(imgs.numpy(), idx.numpy()[..., None], axis=1)
    np.testing.assert_array_equal(carve_micro.sample(imgs, idx).numpy(), ref)
    padded = torch.cat([imgs, imgs.new_zeros(imgs.shape[:2] + (125,))], -1)
    np.testing.assert_array_equal(
        carve_micro.sample(padded, idx)[..., :3].numpy(), ref)
    pts, P34 = x["pts"], x["P34"]
    ph = jnp.concatenate([jnp.asarray(pts.numpy()), jnp.ones((n, 1))], 1)
    np.testing.assert_allclose(
        carve_micro.projection(pts, P34).numpy(),
        np.asarray(jnp.einsum("cij,nj->cni", jnp.asarray(P34.numpy()), ph)),
        rtol=1e-5, atol=1e-5)


TINY_SHAPE = ("tiny", 32, ((0, 16), (4, 20), (6, 22)), 96, 64)


def test_carve_micro_color_shapes_on_the_cpu():
    """``--shapes``' colour rows at small shapes in both layouts: the
    stage equal to its plain version (the CPU runs it), the stride-4 view
    and the contiguous copy as asked, and the bounds counting the bytes
    these inputs need and, apart, every input once."""
    shapes = [TINY_SHAPE + (5, "view"), TINY_SHAPE + (4, "contiguous")]
    rows = carve_micro.color_shapes("cpu", 1, 0, shapes=shapes,
                                    device_timer=lambda fn: 0.25)
    assert [(r["layout"], r["sets"]) for r in rows] == [
        ("view", "ellipsoid"), ("view", "random"),
        ("contiguous", "ellipsoid"), ("contiguous", "random")]
    for r in rows:
        assert r["occupancy_equal"] and r["max_ulps"] == 0
        assert r["ms"] == r["plain_ms"] == r["einsum_ms"] == 0.25
        N, C = r["voxels"], r["cameras"]
        assert N == 16 ** 3 and 0 < r["occupied"] < N
        assert 18 * N < r["bytes"] <= 18 * N + 14 * C * r["occupied"]
        per_colour = 16 if r["layout"] == "view" else 12
        assert r["dense_bytes"] == (per_colour + 2) * C * N + 18 * N
    x = carve_micro.color_inputs("cpu", *TINY_SHAPE[1:], cameras=5)
    assert x[0].stride() == (4 * 16 ** 3, 4, 1)


def test_carve_micro_shapes_on_the_cpu():
    """``--shapes``' rows at a small shape: both kinds of sets, the pair
    equal to its plain version and to the JAX ``ray_cast_visibility_pair``
    on the same arguments, the ellipsoid's sets nested and the random ones
    not, the bound counting the function's own bytes as the kernel's
    source counts them and, apart, the fill of its scratch table."""
    rows = carve_micro.visibility_shapes("cpu", 1, 0, shapes=[TINY_SHAPE],
                                         device_timer=lambda fn: 0.25)
    assert [r["sets"] for r in rows] == ["ellipsoid", "random"]
    for r in rows:
        assert r["bit_equal"] and r["device_ms"] == 0.25
        assert r["occupied"] > 0 and min(r["visible"]) > 0
        N, C, P = r["voxels"], r["cameras"], r["pixels"]
        assert (N, C, P) == (16 ** 3, 5, 96 * 64)
        assert r["bytes"] == 2 * N + 2 * C * N + 12 * C * r["occupied"]
        assert r["fill_bytes"] == 16 * C * P
        assert r["bound_with_fill_ms"] == pytest.approx(
            r["bound_ms"] + r["fill_ms"])
    for sets, nested in (("ellipsoid", True), ("random", False)):
        d, f, o1, o2, P = carve_micro.visibility_inputs(
            "cpu", *TINY_SHAPE[1:], sets=sets)
        assert bool((o1 & ~o2).any()) is not nested
        r1, r2 = jc.ray_cast_visibility_pair(*(jnp.asarray(a.numpy()) for a in (
            d, f, o1, o2)))
        v1, v2 = tc.ray_cast_visibility_pair(d, f, o1, o2, P)
        np.testing.assert_array_equal(v1.numpy(), np.asarray(r1))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(r2))


# ---- dbg_vmap_kernel --------------------------------------------------

def test_vmap_kernel_parity_on_the_cpu():
    """The script's scene at full size: kernel mode (the plain versions
    here) against per-frame global, forward and gradients, at the
    script's tolerances, nothing dropped at the lifted cap."""
    out = vmap_kernel.main(["--device", "cpu"])
    assert out["parity"] and out["fwd_max_abs_err"] <= vmap_kernel.FWD_ATOL
    assert out["dropped_default_cap"] > 0


def test_vmap_scene_overflows_the_jax_row_cap_too():
    """At the default row cap the JAX ``"pallas"`` render of frame 0 drops
    the same instances as the port's and matches it, so the JAX script's
    check cannot hold against the JAX package as it is."""
    x = vmap_kernel.frames()
    with pltpu.force_tpu_interpret_mode():
        rgb, alpha, over = jr.rasterize_2d(
            *(jnp.asarray(a[0]) for a in x), vmap_kernel.W, vmap_kernel.H,
            mode="pallas", sigma_cutoff=30.0, background=jnp.ones(3),
            return_overflow=True)
    got = tr.rasterize_2d(*(torch.from_numpy(a[0]) for a in x),
                          vmap_kernel.W, vmap_kernel.H, mode="kernel",
                          sigma_cutoff=30.0, background=torch.ones(3),
                          return_overflow=True)
    assert int(over) == int(got[2]) == 510
    np.testing.assert_allclose(got[0].numpy(), np.asarray(rgb), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(alpha), atol=1e-5)


# ---- dbg_model_breakdown / dbg_step_bisect ---------------------------

def test_model_probe_builds_the_scripts_cameras_and_frame():
    """``dbg_model_breakdown.py:21-41``: the cameras from the JAX
    ``camera_extrinsic_spherical``, the disc mask and its image."""
    C, H, W = 6, 32, 48
    model, batch = model_bd.model_and_frame(
        torch.device("cpu"), W=W, H=H, grid=32,
        crop=[[0, 16], [0, 16], [8, 24]], min_n=16, max_n=128)
    Es = np.stack([jcam.camera_extrinsic_spherical(1.0, np.pi / 2.2,
                                                   2 * np.pi * i / C)
                   for i in range(C)]).astype(np.float32)
    np.testing.assert_array_equal(model.viewmats.numpy(), Es)
    assert model.observed_views == [0, 1, 2, 3, 4]
    yy, xx = np.mgrid[0:H, 0:W]
    m = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 5) ** 2)
    np.testing.assert_array_equal(batch["mask"][0, 2].numpy(), m)
    np.testing.assert_allclose(batch["img"][0, 1, ..., 2].numpy(), m * 0.5)
    assert float(model.net.head2.bias[0].detach()) == W / 2.0  # centred
