"""The port's public carving API against the JAX package on the CPU:
``ray_cast_visibility`` (both methods, exactly), ``compute_voxel_colors``,
the exact carve's colour stage (``carve_colors_ref``: the former inline
code bit for bit, and its checks), ``shape_carve_volume`` and
``shape_carve_mask`` (within 1e-6),
``w2c_to_c2w`` (bit for bit) and ``require_cv2``. Mirrors
``tests/test_carving.py:66-105``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.ops import carving as jc
from pose_splatter_tpu.preprocess import video as jvideo
from pose_splatter_tpu.utils import cameras as jcam
from pose_splatter_torch.ops import carving as tc
from pose_splatter_torch.preprocess import video as tvideo
from pose_splatter_torch.utils import cameras as tcam

torch.set_num_threads(1)

H, W = 24, 32


def _rig(C=4, seed=0):
    """C cameras on a ring around the origin, looking at it."""
    Ks = np.array([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * C,
                  np.float32)
    Es = np.stack([tcam.camera_extrinsic_spherical(1.5, np.pi / 2.5,
                                                   2 * np.pi * i / C + seed)
                   for i in range(C)]).astype(np.float32)
    return Ks, Es


def _points(n, seed):
    """Random points in a cube around the origin (no two at the same
    distance from a camera, so both packages' sorts pick the same
    winner) and a random occupancy."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    occ = rng.uniform(size=n) < 0.6
    return pts, occ


def _both(fn_j, fn_t, *args):
    ref = np.asarray(fn_j(*[jnp.asarray(a) for a in args]))
    got = fn_t(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()
    return ref, got


@pytest.mark.parametrize("method", ["sort", "segment"])
@pytest.mark.parametrize("n,seed", [(400, 0), (3000, 1)])
def test_ray_cast_visibility_equals_jax(method, n, seed):
    Ks, Es = _rig(seed=seed)
    pts, occ = _points(n, seed)
    ref, got = _both(
        lambda p, o, k, e: jc.ray_cast_visibility(p, o, k, e, H, W, method),
        lambda p, o, k, e: tc.ray_cast_visibility(p, o, k, e, H, W, method),
        pts, occ, Ks, Es)
    assert got.dtype == np.bool_ and got.shape == (4, n)
    np.testing.assert_array_equal(ref, got)
    assert got.sum() > 0 and not got[:, ~occ].any()


def test_sort_has_one_winner_a_pixel_and_segment_keeps_ties():
    """Two occupied voxels at exactly the same distance on one pixel:
    ``"sort"`` marks the lower voxel index, ``"segment"`` both."""
    d = torch.tensor([[1.0, 2.0, 1.0, 0.5]])
    flat = torch.tensor([[7, 7, 7, 3]])
    occ = torch.tensor([True, True, True, False])
    srt = tc.frontmost_visible(d, flat, occ, 16, "sort")
    seg = tc.frontmost_visible(d, flat, occ, 16, "segment")
    assert srt.tolist() == [[True, False, False, False]]
    assert seg.tolist() == [[True, False, True, False]]
    with pytest.raises(ValueError, match="unknown visibility method"):
        tc.frontmost_visible(d, flat, occ, 16, "scan")


def test_nearer_voxel_occludes_and_empty_voxels_do_not_shadow():
    """``tests/test_carving.py:67-88`` on the port, both methods."""
    K = torch.tensor([[[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]]])
    E = torch.eye(4)[None]
    pts = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0], [0.3, 0.3, 1.5]])
    for method in ("sort", "segment"):
        vis = tc.ray_cast_visibility(pts, torch.ones(3, dtype=torch.bool), K,
                                     E, 32, 32, method)
        assert vis[0].tolist() == [True, False, True]
        vis = tc.ray_cast_visibility(pts[:2], torch.tensor([False, True]), K,
                                     E, 32, 32, method)
        assert vis[0].tolist() == [False, True]


def test_the_pair_equals_two_sort_calls():
    """The carve's one-sort pair (``ray_cast_visibility_pair``) is two
    ``"sort"`` visibilities, one a threshold."""
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, (3, 5000)).astype(np.float32))
    flat = torch.from_numpy(rng.integers(0, 400, (3, 5000)))
    occ1 = torch.from_numpy(rng.uniform(size=5000) < 0.2)
    occ2 = occ1 | torch.from_numpy(rng.uniform(size=5000) < 0.3)
    v1, v2 = tc.ray_cast_visibility_pair(d, flat, occ1, occ2, 400)
    assert torch.equal(v1, tc.frontmost_visible(d, flat, occ1, 400))
    assert torch.equal(v2, tc.frontmost_visible(d, flat, occ2, 400))


def _pair_case(case):
    """(dists, flat, occ1, occ2, n_pixels) in numpy for one edge of the
    carve's visibility pair; 3 cameras, 64 pixels."""
    rng = np.random.default_rng(7)
    C, N, P = 3, 600, 64
    dists = rng.integers(0, 12, (C, N)).astype(np.float32) / 4.0  # ties
    flat = rng.integers(0, P, (C, N))
    occ1 = rng.uniform(size=N) < 0.3
    occ2 = occ1 | (rng.uniform(size=N) < 0.3)
    if case == "equal_distances":
        dists[:, :] = 1.25
        flat[:, :40] = 5  # forty voxels at one distance on one pixel
    elif case == "distance_zero":
        dists[:, ::3] = 0.0
    elif case == "none_occupied":
        occ1[:], occ2[:] = False, False
    elif case == "all_occupied":
        occ1[:], occ2[:] = True, True
    elif case == "not_nested":
        occ2 = ~occ1 & (rng.uniform(size=N) < 0.5)
        occ2[::7] = True
    elif case == "one_pixel":
        flat[:, :] = 17
    elif case == "compacted_slots":
        # As the capped carve passes them: the slots of compact_occupied
        # with a cap above the count, each slot's voxel's values; the empty
        # slots read a zero pad row and are in neither set.
        comp, _ = tc.compact_occupied(torch.from_numpy(occ2), 400)
        comp = comp.numpy()
        valid = comp < N
        assert 0 < valid.sum() < len(valid)
        pad = np.concatenate([dists, np.zeros((C, 1), np.float32)], 1)
        dists = np.ascontiguousarray(pad[:, comp])
        flat = np.concatenate([flat, np.zeros((C, 1), np.int64)], 1)[:, comp]
        occ1 = np.concatenate([occ1, [False]])[comp] & valid
        occ2 = valid
    return dists, np.ascontiguousarray(flat), occ1, occ2, P


@pytest.mark.parametrize("case", ["equal_distances", "distance_zero",
                                  "none_occupied", "all_occupied",
                                  "not_nested", "one_pixel",
                                  "compacted_slots"])
def test_min_key_pair_equals_jax_on_the_edges(case):
    """The min-key visibility pair (``visibility_pair_ref``, which the CPU
    runs) against the JAX sort + cumsum + cummax, exactly, on the cases
    random draws miss; also through ``ray_cast_visibility_pair``."""
    dists, flat, occ1, occ2, P = _pair_case(case)
    r1, r2 = jc.ray_cast_visibility_pair(*(jnp.asarray(a) for a in (
        dists, flat, occ1, occ2)))
    t = [torch.from_numpy(a) for a in (dists, flat, occ1, occ2)]
    launched = tc.ray_cast_visibility_pair.launches
    for got in (tc.visibility_pair_ref(*t, P),
                tc.ray_cast_visibility_pair(*t, P)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(r1))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(r2))
    assert tc.ray_cast_visibility_pair.launches == launched  # no kernel here
    v1, v2 = got[0].numpy(), got[1].numpy()
    for v, occ in ((v1, occ1), (v2, occ2)):
        assert not v[:, ~occ].any()
        for c in range(dists.shape[0]):  # one winner a pixel with a voxel
            assert np.array_equal(np.sort(flat[c][v[c]]),
                                  np.unique(flat[c][occ]))
    if case == "equal_distances":
        first = np.flatnonzero(occ1[:40])[0]
        assert v1[:, :40].sum() == dists.shape[0] and v1[:, first].all()
    if case == "none_occupied":
        assert not v1.any() and not v2.any()
    if case == "one_pixel":
        assert (v1.sum(1) == 1).all() and (v2.sum(1) == 1).all()


def _bad_pair(case):
    """The pair's arguments with one fault; nothing large is allocated
    (2^32 voxels only in a [0, 2^32] shape)."""
    d, f = torch.ones((2, 8)), torch.zeros((2, 8), dtype=torch.long)
    o = torch.ones(8, dtype=torch.bool)
    return {"dists_dtype": (d.double(), f, o, o),
            "flat_dtype": (d, f.int(), o, o),
            "occ_dtype": (d, f, o, o.to(torch.uint8)),
            "occ_shape": (d, f, o[:7], o),
            "flat_shape": (d, f[:1], o, o),
            "dists_1d": (d[0], f, o, o),
            "not_contiguous": (d, torch.zeros((8, 2), dtype=torch.long).T,
                               o, o),
            "device": (d, f, o, o.to("meta")),
            "too_many_voxels": (torch.empty((0, 1 << 32)), f, o, o)}[case]


@pytest.mark.parametrize("case,error,match", [
    ("dists_dtype", TypeError, "dists has dtype"),
    ("flat_dtype", TypeError, "flat has dtype"),
    ("occ_dtype", TypeError, "occ2 has dtype"),
    ("occ_shape", ValueError, "occ1 has shape"),
    ("flat_shape", ValueError, "flat has shape"),
    ("dists_1d", ValueError, "expected \\[C, N\\]"),
    ("not_contiguous", ValueError, "flat must be contiguous"),
    ("device", ValueError, "occ2 is on meta"),
    ("too_many_voxels", ValueError, "fewer than 2\\^32"),
])
def test_pair_checks_its_inputs(case, error, match):
    """The pair's checks, the same on every device, read shapes only."""
    with pytest.raises(error, match=match):
        tc.ray_cast_visibility_pair(*_bad_pair(case), 16)


@pytest.mark.parametrize("nonvisible_weight", [0.25, 0.5])
def test_compute_voxel_colors_matches_jax(nonvisible_weight):
    Ks, Es = _rig(seed=2)
    pts, occ = _points(1500, 2)
    imgs = np.random.default_rng(5).uniform(
        size=(4, H, W, 3)).astype(np.float32)
    ref, got = _both(
        lambda *a: jc.compute_voxel_colors(*a, nonvisible_weight),
        lambda *a: tc.compute_voxel_colors(*a, nonvisible_weight),
        pts, occ, imgs, Ks, Es)
    assert got.shape == (1500, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_compute_voxel_colors_weighting():
    """``tests/test_carving.py:91-105`` on the port: a voxel seen by both
    cameras gets the mean colour."""
    K = torch.tensor([[[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]]] * 2)
    E1 = np.eye(4)
    E1[2, 3] = 2.0
    E2 = np.eye(4)
    E2[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    E2[2, 3] = 2.0
    E = torch.from_numpy(np.stack([E1, E2]).astype(np.float32))
    imgs = torch.stack([torch.full((32, 32, 3), 0.2), torch.full((32, 32, 3), 0.8)])
    colors = tc.compute_voxel_colors(torch.zeros((1, 3)),
                                     torch.tensor([True]), imgs, K, E)
    assert torch.allclose(colors[0], torch.tensor(0.5), atol=1e-5)


def _inline_carve_colors(sampled, vis1, vis2, occ1, occ2, nonvisible_weight,
                         volume_fill_color):
    """The exact carve's colour stage as ``carve_volume`` wrote it inline
    before it became ``carve_colors_ref``, line for line."""
    N = sampled.shape[1]

    def volume(occupied, colors):
        vol_rgb = torch.where(occupied[:, None], colors,
                              torch.full_like(colors, volume_fill_color))
        return torch.cat([occupied.float()[None, :], vol_rgb.T], dim=0)

    def weights_of(visible):
        weights = torch.where(visible, 1.0, nonvisible_weight)
        return weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)

    out = torch.zeros((4, N), dtype=torch.float32, device=sampled.device)
    for occupied, visible in ((occ1, vis1), (occ2, vis2)):
        colors = torch.einsum("cn,cnk->nk", weights_of(visible), sampled)
        out = out + volume(occupied, colors) / 2.0
    return out


def _color_stage(C, N, seed, layout):
    """Random colours ([C, N, 4] cut to 3 channels as the fused gather's
    view, or a contiguous [C, N, 3]), visibility and occupancy sets that
    are not nested, a voxel seen by no camera and an all-empty camera."""
    g = torch.Generator().manual_seed(seed)
    samp = torch.rand((C, N, 4), generator=g)[..., :3]
    if layout == "contiguous":
        samp = samp.contiguous()
    occ1 = torch.rand(N, generator=g) < 0.4
    occ2 = torch.rand(N, generator=g) < 0.7
    vis1 = (torch.rand((C, N), generator=g) < 0.5) & occ1
    vis2 = (torch.rand((C, N), generator=g) < 0.5) & occ2
    vis1[:, 0] = vis2[:, 0] = False
    occ1[0] = occ2[0] = True
    vis1[-1] = vis2[-1] = False
    return samp, vis1, vis2, occ1, occ2


@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("nonvisible_weight,fill", [(0.25, 0.45), (0.1, 0.3)])
def test_carve_colors_ref_is_the_inline_code_and_the_jax_carve(
        layout, nonvisible_weight, fill):
    """``carve_colors_ref`` and the CPU's ``carve_colors_pair`` (which
    launches nothing) equal the carve's former inline code bit for bit;
    against the JAX carve's colour stage (``carving.py:317-326``) the
    occupancy is exact and the colours within 1e-6."""
    x = _color_stage(5, 3000, 7, layout)
    launched = tc.carve_colors_pair.launches
    inline = _inline_carve_colors(*x, nonvisible_weight, fill)
    assert torch.equal(tc.carve_colors_ref(*x, nonvisible_weight, fill), inline)
    assert torch.equal(tc.carve_colors_pair(*x, nonvisible_weight, fill), inline)
    assert tc.carve_colors_pair.launches == launched  # no kernel here
    sampled, vis1, vis2, occ1, occ2 = (jnp.asarray(a.numpy()) for a in x)
    out = jnp.zeros((4, sampled.shape[1]), dtype=jnp.float32)
    for occupied, visible in ((occ1, vis1), (occ2, vis2)):
        weights = jnp.where(visible, 1.0, nonvisible_weight)
        weights = weights / jnp.clip(weights.sum(axis=0, keepdims=True), 1e-8)
        colors = jnp.einsum("cn,cnk->nk", weights, sampled)
        vol_rgb = jnp.where(occupied[:, None], colors, fill)
        out = out + jnp.concatenate(
            [occupied.astype(jnp.float32)[None, :], vol_rgb.T], axis=0) / 2.0
    out = np.asarray(out)
    np.testing.assert_array_equal(inline[0].numpy(), out[0])
    np.testing.assert_allclose(inline.numpy(), out, rtol=0, atol=1e-6)


def _bad_colors(case):
    s = torch.rand((2, 8, 3))
    v = torch.ones((2, 8), dtype=torch.bool)
    o = torch.ones(8, dtype=torch.bool)
    many = torch.ones((65, 8), dtype=torch.bool)
    return {"sampled_dtype": (s.double(), v, v, o, o),
            "sampled_shape": (s[..., :2], v, v, o, o),
            "channels_apart": (s.transpose(0, 2).contiguous().transpose(0, 2),
                               v, v, o, o),
            "vis_dtype": (s, v.float(), v, o, o),
            "occ_shape": (s, v, v, o[:7], o),
            "vis_not_contiguous": (s, v, torch.ones((8, 2), dtype=torch.bool).T,
                                   o, o),
            "device": (s, v, v, o, o.to("meta")),
            "too_many_cameras": (torch.rand((65, 8, 3)), many, many, o, o),
            "requires_grad": (s.requires_grad_(), v, v, o, o)}[case]


@pytest.mark.parametrize("case,error,match", [
    ("sampled_dtype", TypeError, "sampled has dtype"),
    ("sampled_shape", ValueError, "expected \\[C, N, 3\\]"),
    ("channels_apart", ValueError, "channels must be adjacent"),
    ("vis_dtype", TypeError, "vis1 has dtype"),
    ("occ_shape", ValueError, "occ1 has shape"),
    ("vis_not_contiguous", ValueError, "vis2 must be contiguous"),
    ("device", ValueError, "occ2 is on meta"),
    ("too_many_cameras", ValueError, "at most 64"),
    ("requires_grad", ValueError, "forward only"),
])
def test_carve_colors_checks_its_inputs(case, error, match):
    """The colour stage's checks, the same on every device, read shapes
    only; nothing is launched."""
    launched = tc.carve_colors_pair.launches
    with pytest.raises(error, match=match):
        tc.carve_colors_pair(*_bad_colors(case), 0.25, 0.45)
    assert tc.carve_colors_pair.launches == launched


@pytest.mark.parametrize("C,eps", [(6, 1e-2), (4, 0.05)])
def test_shape_carve_volume_and_mask_match_jax(C, eps):
    rng = np.random.default_rng(C)
    # Values on and near the thresholds, where float32 decides.
    th = np.array([(C - 1.0) / C - eps, 1.0 - eps, (C - 2.0) / C - eps],
                  np.float32)
    vol = rng.choice(np.concatenate([th, th + 1e-7, th - 1e-7,
                                     rng.uniform(size=30)]).astype(np.float32),
                     size=(5, 6, 7, 8))
    mask_vol = vol[:1]
    img_vol = rng.uniform(size=(3, 6, 7, 8)).astype(np.float32)
    ref, got = _both(lambda m, i: jc.shape_carve_volume(m, i, C, eps),
                     lambda m, i: tc.shape_carve_volume(m, i, C, eps),
                     mask_vol, img_vol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got == 1.0).any() and (got < 1.0).any()
    ref, got = _both(lambda v: jc.shape_carve_mask(v, C, eps),
                     lambda v: tc.shape_carve_mask(v, C, eps), vol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.dtype == np.float32 and set(np.unique(got[:3])) == {0.0, 1.0}


def test_w2c_to_c2w_is_bit_equal():
    Ks, Es = _rig(C=5)
    w2c = Es.astype(np.float64) + np.random.default_rng(0).normal(
        0, 1e-3, Es.shape) * np.array([1, 1, 1, 0])
    np.testing.assert_array_equal(tcam.w2c_to_c2w(w2c.copy()),
                                  jcam.w2c_to_c2w(w2c.copy()))


def test_require_cv2():
    """Both packages' gate passes here (cv2 is installed); the port's also
    hands back the module, which its decode functions use."""
    jvideo.require_cv2()
    cv2 = tvideo.require_cv2()
    assert hasattr(cv2, "VideoCapture")
