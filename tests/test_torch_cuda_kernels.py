"""The port's CUDA kernels against their plain PyTorch versions, on the
card. The forward and backward compositors: tile shapes and chunk sizes
beyond the main path's, empty and ragged segments, early stop, a tile of
over 200 chunks spread over as many blocks, bit-identical reruns, the
forward's ``tbounds`` store, instance arrays of projected 3D Gaussians, the
3D rasterizer's gradients against the CPU's, the launch counts and the
wrappers' checks. The dynamic gather: both axes at the probe's shape,
bit-equal, odd shapes and the index check.

Every test is marked ``cuda`` and skips where no CUDA device is present
(the kernel has no CPU mode). On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda_kernels.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax, which such a
machine need not have; this file imports only the port.)
"""

import numpy as np
import pytest
import torch

from pose_splatter_torch.ops import dyngather as tdg
from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk
from pose_splatter_torch.utils import stages

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# Same math, sums in another order (sequential products in the kernel,
# chunked cumprod in the plain version): float32 rounding only.
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernel has no CPU mode")
    return torch.device("cuda")


def _binned(dev, mode, tile, chunk, n=1500, views=2, height=96, width=200,
            seed=0):
    """Random Gaussians of ``views`` cameras binned at ``tile`` / ``chunk``.
    They cover the upper 45% of the image (some reach past its left and
    right edges), so the bottom rows of tiles have no instances."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen)

    means = torch.stack([width * (1.1 * rnd(views, n) - 0.05),
                         0.45 * height * rnd(views, n)], -1)
    colors = rnd(n, 3).expand(views, -1, -1)
    valid = rnd(views, n) < 0.9
    if mode == "ellipse":
        scales = 0.7 + 4.0 * rnd(n, 2)
        radius = 3.0 * scales.amax(1)
        packed = tk.pack_ellipse(means, scales.expand(views, -1, -1),
                                 (6 * rnd(n) - 3).expand(views, -1),
                                 (0.1 + 0.85 * rnd(n)).expand(views, -1),
                                 colors, radius.expand(views, -1))
    else:
        sig = 1.0 + 6.0 * rnd(n, 2)
        th = 6 * rnd(n) - 3
        c, s = torch.cos(th), torch.sin(th)
        ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
        conic = torch.stack([c * c * ia + s * s * ib, c * s * (ia - ib),
                             s * s * ia + c * c * ib], -1)
        radius = 3.0 * sig.amax(1)
        packed = tk.pack_conic(means, conic.expand(views, -1, -1),
                               (0.7 + 0.29 * rnd(n)).expand(views, -1),
                               colors, radius.expand(views, -1))
    b = tr.bin_instances(packed.to(dev), means.to(dev),
                         radius.expand(views, -1).to(dev), valid.to(dev),
                         height, width, tile, chunk, 16)
    return b.inst, b.astarts, b.counts, b.origins, tile, chunk, mode


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
@pytest.mark.parametrize("tile,chunk", [((8, 128), 64), ((16, 16), 64),
                                        ((4, 8), 16), ((32, 32), 128)])
def test_kernel_matches_plain(dev, mode, tile, chunk):
    args = _binned(dev, mode, tile, chunk)
    counts = args[2]
    assert (counts == 0).any() and (counts % chunk != 0).any()
    before = tk.composite_instances.launches
    got = tk.composite_instances(*args)
    torch.cuda.synchronize()
    assert tk.composite_instances.launches == before + 1
    ref = tk.composite_instances_ref(*args)
    P = tile[0] * tile[1]
    assert got[0].shape == (counts.numel(), 3, P)
    assert got[1].shape == (counts.numel(), P)
    torch.testing.assert_close(got[0], ref[0], atol=TOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=TOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    n_steps = (counts + chunk - 1) // chunk
    if mode == "conic":
        assert (got[2] <= n_steps).all()
        if chunk <= 64:  # dense tiles stop before their last chunk
            assert (got[2] < n_steps).any()
    else:
        assert torch.equal(got[2], n_steps.int())
    empty = counts == 0
    assert (got[1][empty] == 0).all() and (got[0][empty] == 0).all()


def test_kernel_with_no_tiles(dev):
    inst = torch.zeros((64, tk.F), device=dev)
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    before = tk.composite_instances.launches
    rgb, alpha, jstop = tk.composite_instances(
        inst, none, none, torch.zeros((0, 2), dtype=torch.int32, device=dev),
        (8, 128), 64, "ellipse")
    assert rgb.shape == (0, 3, 1024) and alpha.shape == (0, 1024)
    assert jstop.shape == (0,)
    assert tk.composite_instances.launches == before  # nothing was launched


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    inst, astarts, counts, origins, tile, chunk, mode = _binned(
        dev, "ellipse", (8, 128), 64)
    before = tk.composite_instances.launches
    bad = [
        (inst.double(), astarts, counts, origins, tile, chunk),
        (inst, astarts.long(), counts, origins, tile, chunk),
        (inst, astarts, counts.cpu(), origins, tile, chunk),
        (inst, astarts, counts, origins.t().contiguous().t(), tile, chunk),
        (inst, astarts, counts, origins[:-1], tile, chunk),
        (inst[:-1], astarts, counts, origins, tile, chunk),  # rows % chunk
        (inst, astarts, counts, origins, (16, 128), chunk),  # P > 1024
        (inst, astarts, counts, origins, tile, 1024),  # chunk > 768 rows
    ]
    for case in bad:
        with pytest.raises((ValueError, TypeError)):
            tk.composite_instances(*case, mode)
    assert tk.composite_instances.launches == before


def _backward_inputs(args, seed=1):
    inst, astarts, counts, origins, tile, chunk, mode = args
    rgb, alpha, jstop, tbounds = tk.composite_instances(*args, save_tbounds=True)
    gen = torch.Generator().manual_seed(seed)
    P = tile[0] * tile[1]
    g_rgb = torch.randn((counts.numel(), 3, P), generator=gen).to(inst.device)
    g_alpha = torch.randn((counts.numel(), P), generator=gen).to(inst.device)
    return (inst, tbounds, astarts, counts, origins, jstop, g_rgb, g_alpha,
            tile, chunk, mode)


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
@pytest.mark.parametrize("tile,chunk", [((8, 128), 64), ((16, 16), 64),
                                        ((4, 8), 16), ((32, 32), 128)])
def test_backward_kernel_matches_plain(dev, mode, tile, chunk):
    args = _binned(dev, mode, tile, chunk)
    plain = tk.composite_instances_ref(*args, save_tbounds=True)
    bargs = _backward_inputs(args)
    # The store: the plain version's entry T (same chunked products, TOL).
    torch.testing.assert_close(bargs[1], plain[3], atol=TOL, rtol=0)
    assert torch.equal(bargs[5], plain[2])
    before = tk.composite_instances_bwd.launches
    got = tk.composite_instances_bwd(*bargs)
    torch.cuda.synchronize()
    assert tk.composite_instances_bwd.launches == before + 1
    ref = tk.composite_instances_bwd_ref(*bargs)
    # Each gradient sums over P pixels terms carrying a suffix over the
    # tile's walked rows, in another order: within 1e-4 of each column's
    # largest entry (float32 roundoff times sqrt(P x rows) is below that).
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    assert ((got - ref).abs() <= 1e-4 * scale).all()
    assert float(got.abs().max()) > 0 and torch.isfinite(got).all()
    assert (got[:, 10:] == 0).all()
    if mode == "conic":
        assert (got[:, 5] == 0).all()
    # Rows no tile walked keep their zeros.
    walked = torch.zeros(got.shape[0], dtype=torch.bool, device=dev)
    for a, n in zip(args[1].tolist(), bargs[3].tolist()):
        walked[a:a + n] = True
    assert (got[~walked] == 0).all()
    again = tk.composite_instances_bwd(*bargs)
    assert torch.equal(got, again)  # no atomics: bit-identical reruns


def test_backward_kernel_with_no_tiles(dev):
    inst = torch.zeros((64, tk.F), device=dev)
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    before = tk.composite_instances_bwd.launches
    d = tk.composite_instances_bwd(
        inst, torch.zeros((1, 1024), device=dev), none, none,
        torch.zeros((0, 2), dtype=torch.int32, device=dev), none,
        torch.zeros((0, 3, 1024), device=dev), torch.zeros((0, 1024), device=dev),
        (8, 128), 64, "ellipse")
    assert d.shape == inst.shape and (d == 0).all()
    assert tk.composite_instances_bwd.launches == before


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(dev):
    b = list(_backward_inputs(_binned(dev, "ellipse", (8, 128), 64)))
    before = tk.composite_instances_bwd.launches
    swaps = [
        (1, b[1][:-1]),                        # tbounds rows
        (1, b[1].double()),                    # tbounds dtype
        (5, b[5].long()),                      # jstop dtype
        (6, b[6][:, :2].contiguous()),         # g_rgb shape
        (7, b[7].t().contiguous().t()),        # g_alpha not contiguous
        (7, b[7].cpu()),                       # g_alpha device
        (9, 1024),                             # chunk > 512 rows
    ]
    for i, value in swaps:
        case = list(b)
        case[i] = value
        with pytest.raises((ValueError, TypeError)):
            tk.composite_instances_bwd(*case)
    assert tk.composite_instances_bwd.launches == before


def _hot_tile_scene(dev, mode, n=15000, seed=4):
    """One camera at 64x256 ((8, 128) tiles, G = 64) whose first tile holds
    over 200 chunks (the main path's most loaded tile walks 200-218), as
    small faint Gaussians that leave T >= 1e-4 on part of the tile; in
    conic mode a band of large opaque ones across the next tile row down
    makes that row stop part-way along its segments."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen)

    hot = rnd(n) < 0.95
    x = torch.where(hot, 4 + 120 * rnd(n), 256 * rnd(n))
    y = torch.where(hot, 1 + 6 * rnd(n), 10 + 4 * rnd(n))
    means = torch.stack([x, y], -1)[None]
    sig = torch.where(hot[:, None], 0.4 + 0.4 * rnd(n, 2), 3 + 2 * rnd(n, 2))
    opac = torch.where(hot, 0.03 + 0.1 * rnd(n), 0.8 + 0.19 * rnd(n))
    colors = rnd(n, 3)[None]
    radius = torch.where(hot, torch.full((n,), 0.9), 3.0 * sig.amax(1))
    if mode == "ellipse":
        packed = tk.pack_ellipse(means, sig[None], (6 * rnd(n) - 3)[None],
                                 opac[None], colors, radius[None])
    else:
        th = 6 * rnd(n) - 3
        c, s = torch.cos(th), torch.sin(th)
        ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
        conic = torch.stack([c * c * ia + s * s * ib, c * s * (ia - ib),
                             s * s * ia + c * c * ib], -1)
        packed = tk.pack_conic(means, conic[None], opac[None], colors,
                               radius[None])
    valid = torch.ones((1, n), dtype=torch.bool)
    b = tr.bin_instances(packed.to(dev), means.to(dev), radius[None].to(dev),
                         valid.to(dev), 64, 256, tr.DEFAULT_TILE,
                         tr.DEFAULT_CHUNK, 16)
    return b.inst, b.astarts, b.counts, b.origins, tr.DEFAULT_TILE, \
        tr.DEFAULT_CHUNK, mode


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
def test_kernels_on_a_hot_tile_match_plain_and_rerun_bit_equal(dev, mode):
    """The split's long carries: a tile of over 200 chunks (spread over as
    many blocks, T and the suffix carried between them) and, in conic mode,
    tiles that stop part-way. Both kernels against their plain versions,
    jstop equal; reruns bit-identical."""
    args = _hot_tile_scene(dev, mode)
    G = args[5]
    n_steps = (args[2].long() + G - 1) // G
    assert int(n_steps.max()) >= 200
    got = tk.composite_instances(*args, save_tbounds=True)
    ref = tk.composite_instances_ref(*args, save_tbounds=True)
    for x, y in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        torch.testing.assert_close(x, y, atol=TOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    jstop = got[2].long()
    hot = int(n_steps.argmax())
    assert jstop[hot] == n_steps[hot]  # the long segment is walked whole
    if mode == "conic":
        assert ((jstop > 1) & (jstop < n_steps - 1)).any()
    again = tk.composite_instances(*args, save_tbounds=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))

    gen = torch.Generator().manual_seed(5)
    nt, P = args[2].numel(), 1024
    bargs = (args[0], got[3], args[1], args[2], args[3], got[2],
             torch.randn((nt, 3, P), generator=gen).to(dev),
             torch.randn((nt, P), generator=gen).to(dev)) + args[4:]
    d = tk.composite_instances_bwd(*bargs)
    d_ref = tk.composite_instances_bwd_ref(*bargs)
    # chip_smoke.py::bwd_error's tolerance: float32 roundings of sums over
    # P pixels of suffixes over up to all the tile's walked rows.
    tol = 4 * 2.0 ** -24 * (P * int(jstop.max()) * G) ** 0.5
    scale = d_ref.abs().amax(dim=0).clamp_min(1e-30)
    assert float(((d - d_ref).abs().amax(dim=0) / scale).max()) <= tol
    assert torch.isfinite(d).all() and float(d.abs().max()) > 0
    assert torch.equal(d, tk.composite_instances_bwd(*bargs))


# ----------------------------------------------------------------------------
# Compositors on projected 3D Gaussians (conic mode, depth order).
# ----------------------------------------------------------------------------

def _scene_3d(n=3000, seed=0):
    """3D Gaussians seen by two cameras at 288x256 (the 3D configuration's
    render size), as numpy float32 arrays: a dense horizontal band across
    the whole image width, so whole (8, 128) tiles saturate and stop
    early."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.35, 0.35, n), rng.normal(0, 0.02, n),
                      rng.normal(1.2, 0.06, n)], 1)
    c, s = np.cos(0.4), np.sin(0.4)
    E2 = np.array([[c, 0, s, -0.4], [0, 1, 0, 0], [-s, 0, c, 0.1],
                   [0, 0, 0, 1]])
    K = np.array([[500.0, 0, 144], [0, 500.0, 128], [0, 0, 1]])
    g = dict(means=means, quats=rng.normal(size=(n, 4)),
             scales=np.exp(rng.normal(-4.5, 0.3, (n, 3))),
             opacities=rng.uniform(0.3, 0.95, n),
             colors=rng.uniform(0, 1, (n, 3)),
             viewmats=np.stack([np.eye(4), E2]), Ks=np.stack([K, K]))
    return {k: v.astype(np.float32) for k, v in g.items()}


def _rasterize_3d(g, dev, grad=False):
    t = {k: torch.from_numpy(v).to(dev).requires_grad_(
        grad and k not in ("viewmats", "Ks")) for k, v in g.items()}
    out = tr.rasterize(t["means"], t["quats"], t["scales"], t["opacities"],
                       t["colors"], t["viewmats"], t["Ks"], 288, 256,
                       backgrounds=torch.ones(3, device=dev))
    return t, out


def test_compositors_on_projected_3d_instances(dev):
    """The instance arrays that the 3D rasterizer itself binned (depth
    order, conic packing, two cameras in one launch)."""
    with torch.no_grad(), stages.record("cuda") as rec:
        _rasterize_3d(_scene_3d(), dev)
    b = rec.values["binning"][0]
    args = (b.inst, b.astarts, b.counts, b.origins, tr.DEFAULT_TILE,
            tr.DEFAULT_CHUNK, "conic")
    got = tk.composite_instances(*args, save_tbounds=True)
    ref = tk.composite_instances_ref(*args, save_tbounds=True)
    for x, y in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        torch.testing.assert_close(x, y, atol=TOL, rtol=0)
    assert torch.equal(got[2], ref[2])
    n_steps = (b.counts + tr.DEFAULT_CHUNK - 1) // tr.DEFAULT_CHUNK
    assert (got[2] < n_steps).any()  # the dense cluster stops early
    gen = torch.Generator().manual_seed(3)
    P = tr.DEFAULT_TILE[0] * tr.DEFAULT_TILE[1]
    nt = b.counts.numel()
    bargs = (b.inst, got[3], b.astarts, b.counts, b.origins, got[2],
             torch.randn((nt, 3, P), generator=gen).to(dev),
             torch.randn((nt, P), generator=gen).to(dev), tr.DEFAULT_TILE,
             tr.DEFAULT_CHUNK, "conic")
    d = tk.composite_instances_bwd(*bargs)
    d_ref = tk.composite_instances_bwd_ref(*bargs)
    scale = d_ref.abs().amax(dim=0).clamp_min(1e-30)
    assert ((d - d_ref).abs() <= 1e-4 * scale).all()
    assert float(d.abs().max()) > 0


def test_rasterize_3d_gradients_on_the_card_match_the_cpu(dev):
    """rasterize's forward and backward through both kernels against the
    plain versions on the CPU: gradients within 3e-4 of each tensor's
    largest entry. The images are held in the test above on shared
    instance arrays: here the projections run on two devices, whose exp
    and sqrt may differ in the last bit, and a pixel-Gaussian pair within
    that of a gate may flip (a step of up to 1/255 at one pixel, too small
    to show in a summed gradient)."""
    g = _scene_3d(1200, 1)
    outs = []
    for d in (dev, torch.device("cpu")):
        fwd, bwd = tk.composite_instances.launches, tk.composite_instances_bwd.launches
        t, (rgb, alpha) = _rasterize_3d(g, d, grad=True)
        ((rgb ** 2).sum() + (alpha ** 2).sum()).backward()
        launched = (tk.composite_instances.launches - fwd,
                    tk.composite_instances_bwd.launches - bwd)
        assert launched == ((1, 1) if d.type == "cuda" else (0, 0))
        outs.append([rgb.detach().cpu(), alpha.detach().cpu()]
                    + [t[k].grad.cpu() for k in ("means", "quats", "scales",
                                                 "opacities", "colors")])
    assert float(outs[0][1].max()) > 0.9
    for a, b in zip(outs[0][2:], outs[1][2:]):
        assert ((a - b).abs() <= 3e-4 * b.abs().max()).all()


# ----------------------------------------------------------------------------
# The dynamic gather (the dyngather probe kernels).
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 2, 32])
def test_dyngather_kernel_equals_plain(dev, axis, reps):
    """At the probe's [2304, 128]: sequential float32 sums on both sides,
    so equal, not close."""
    gen = torch.Generator().manual_seed(10 * axis + reps)
    S, L = 2304, 128
    dim = S if axis == 0 else L
    tab = torch.randn((S, L), generator=gen).to(dev)
    idx = torch.randint(0, dim - (reps > 1), (S, L), generator=gen,
                        dtype=torch.int32).to(dev)
    wrapper = tdg.gather if reps == 1 else tdg.gather_sum
    before = wrapper.launches
    got = (tdg.gather(tab, idx, axis) if reps == 1
           else tdg.gather_sum(tab, idx, axis, reps))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, tdg.gather_sum_ref(tab, idx, axis, reps))


@pytest.mark.parametrize("shape,axis,reps", [
    ((2304, 128), 0, 32),  # row broadcast: every lane of a row reads one row
    ((37, 300), 1, 5),     # a row wider than the block: threads loop
    ((5, 20000), 0, 3),    # many columns, few rows
    ((300, 7), 1, 2),      # a row narrower than a warp
])
def test_dyngather_other_shapes(dev, shape, axis, reps):
    gen = torch.Generator().manual_seed(7)
    S, L = shape
    dim = shape[axis]
    tab = torch.randn(shape, generator=gen).to(dev)
    if S == 2304:
        idx = torch.randint(0, dim - 1, (S, 1), generator=gen,
                            dtype=torch.int32).repeat(1, L).to(dev)
    else:
        idx = torch.randint(0, dim - 1, shape, generator=gen,
                            dtype=torch.int32).to(dev)
    got = tdg.gather_sum(tab, idx, axis, reps)
    assert torch.equal(got, tdg.gather_sum_ref(tab, idx, axis, reps))


def test_dyngather_wrapper_rejects_what_the_kernel_does_not_take(dev):
    tab = torch.zeros((64, 128), device=dev)
    idx = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    before = tdg.gather_sum.launches
    edge = idx.clone()
    edge[3, 4] = 63
    with pytest.raises(IndexError):  # 63 + offset 1 is off the table
        tdg.gather_sum(tab, edge, 0, 2)
    with pytest.raises(IndexError):
        tdg.gather_sum(tab, idx - 1, 1, 1)
    with pytest.raises(ValueError):
        tdg.gather_sum(tab, idx.cpu(), 0, 1)
    with pytest.raises(ValueError):  # axis 1 rows beyond shared memory
        tdg.gather_sum(torch.zeros((1, 20000), device=dev),
                       torch.zeros((1, 20000), dtype=torch.int32, device=dev),
                       1, 1)
    assert tdg.gather_sum.launches == before


def test_dyngather_probe_counts_every_launch(dev):
    """The probe's timed launches go through the counted ``launch``: its
    count is one checked call, the warm-up and the timed loop."""
    from pose_splatter_torch.scripts import dbg_dyngather_micro as probe

    before = tdg.gather_sum.launches
    line = probe.probe(0, "dim0 random", np.random.default_rng(0).integers(
        0, probe.S - 1, (probe.S, probe.L)), np.random.default_rng(1), "card")
    assert tdg.gather_sum.launches - before == 1 + probe.WARMUP + probe.ITERS
    assert line["ms"] > 0
