"""The port's CUDA kernels against their plain PyTorch versions, on the
card. The forward and backward compositors: tile shapes and chunk sizes
beyond the main path's, empty and ragged segments, early stop, a tile of
over 200 chunks spread over as many blocks, bit-identical reruns, the
forward's ``tbounds`` store, instance arrays of projected 3D Gaussians, the
3D rasterizer's gradients against the CPU's, the launch counts and the
wrappers' checks. The dynamic gather: both axes at the probe's shape,
bit-equal, odd shapes and the index check; which path the C entry takes
(vector at the probe's shape and for ragged row blocks, scalar for rows
of no whole quads and for misaligned views), the widest axis-1 row, and
bit-identical reruns. The train step captured in a CUDA graph
(``make_train_multi_step``) against the eager step in both modes, its
selection flag, the selection's device route against the host loops, and
capturable Adam against the eager update. The bench counterpart and
``graft_entry.entry`` turning TF32 off, the bench's fwd+bwd on the card
against the CPU's and its CUDA-graph capture in kernel and tiled mode,
and the O(P) ``composite_pixels`` against autograd through its scan.
The carve's visibility kernel against its plain version at the main
path's three carve shapes, under CUDA-graph capture, inside
``carve_volume`` and its wrapper's checks. The carve's visibility cap on
the card against the CPU, a remat train
step against one without remat, and a captured step with the cap and
remat against its eager twin. The final U-Net's backward at the presets'
crop with cuDNN's autotuning: off the direct weight-gradient kernel and
under 10 ms on the card. ResNet18, LPIPS, one frame of the
visual-pose features and the preprocessing carves on the card against the
CPU, and the forward kernel on a spherical rig's binned arrays.

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


def bwd_tol(tile, jstop, G):
    """The backward's bound relative to each gradient column's largest
    entry: float32 roundings of sums over a tile's P pixels of suffixes
    over up to all its walked rows, a random walk, 4·eps·sqrt(P·rows)."""
    return 4 * 2.0 ** -24 * (tile[0] * tile[1]
                             * max(int(jstop.max()) * G, 1)) ** 0.5


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
@pytest.mark.parametrize("tile,chunk", [((8, 128), 64), ((8, 64), 64),
                                        ((16, 16), 64), ((4, 8), 16),
                                        ((32, 32), 128)])
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
@pytest.mark.parametrize("tile,chunk", [((8, 128), 64), ((8, 64), 64),
                                        ((16, 16), 64), ((4, 8), 16),
                                        ((32, 32), 128)])
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
    tol = bwd_tol(args[4], jstop, G)
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


@pytest.mark.parametrize("shape", [(0, 128), (2304, 0)])
@pytest.mark.parametrize("axis", [0, 1])
def test_dyngather_empty_table_launches_nothing(dev, shape, axis):
    tab = torch.zeros(shape, device=dev)
    idx = torch.zeros(shape, dtype=torch.int32, device=dev)
    before = tdg.gather_sum.launches
    assert tdg.launch(tdg.gather_sum, tab, idx, torch.empty_like(tab), axis,
                      2) == "none"
    assert tdg.gather_sum(tab, idx, axis, 2).shape == shape
    assert tdg.gather_sum.launches == before


def test_dyngather_probe_counts_every_launch(dev):
    """The probe's timed launches go through the counted ``launch``: its
    count is one checked call, the warm-up and the timed loop. The probe's
    entry point: its check against numpy passes on both axes (one gather
    each), and its three lines count alike."""
    from pose_splatter_torch.scripts import dbg_dyngather_micro as probe

    before = tdg.gather_sum.launches
    line = probe.probe(0, "dim0 random", np.random.default_rng(0).integers(
        0, probe.S - 1, (probe.S, probe.L)), np.random.default_rng(1), "card")
    assert tdg.gather_sum.launches - before == 1 + probe.WARMUP + probe.ITERS
    assert line["ms"] > 0
    before = (tdg.gather_sum.launches, tdg.gather.launches)
    out = probe.run(seed=0)
    assert out["correct"] == {0: True, 1: True}
    assert (tdg.gather_sum.launches - before[0],
            tdg.gather.launches - before[1]) == (
        3 * (1 + probe.WARMUP + probe.ITERS), 2)


def _gather_inputs(dev, shape, axis, reps, seed, tab_offset=0, idx_offset=0):
    """A random table and indices of ``shape``; a nonzero offset makes that
    tensor a contiguous view ``offset`` elements into a larger one, so its
    data pointer is not 16-byte aligned."""
    gen = torch.Generator().manual_seed(seed)
    S, L = shape
    n = S * L
    tab = torch.randn(n + tab_offset, generator=gen).to(dev)
    idx = torch.randint(0, shape[axis] - (reps > 1), (n + idx_offset,),
                        generator=gen, dtype=torch.int32).to(dev)
    return (tab.view(-1)[tab_offset:tab_offset + n].view(S, L),
            idx.view(-1)[idx_offset:idx_offset + n].view(S, L))


def _gather_path(tab, idx, axis, reps):
    """The wrapper's result against the plain version, then the kernel
    launched twice more through ``launch``: both runs bit-identical to the
    first. Returns the path the C entry reports."""
    wrapper = tdg.gather if reps == 1 else tdg.gather_sum
    got = tdg.gather_sum(tab, idx, axis, reps)
    assert torch.equal(got, tdg.gather_sum_ref(tab, idx, axis, reps))
    paths = set()
    for _ in range(2):
        out = torch.full_like(tab, float("nan"))
        paths.add(tdg.launch(wrapper, tab, idx, out, axis, reps))
        torch.cuda.synchronize()
        assert torch.equal(out, got)
    assert len(paths) == 1
    return paths.pop()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 2, 32])
def test_dyngather_takes_the_vector_path_at_the_probe_shape(dev, axis, reps):
    tab, idx = _gather_inputs(dev, (2304, 128), axis, reps, seed=reps)
    assert _gather_path(tab, idx, axis, reps) == "vector"


@pytest.mark.parametrize("shape", [(301, 130), (300, 7)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 2, 32])
def test_dyngather_rows_of_no_whole_quads_take_the_scalar_path(
        dev, shape, axis, reps):
    """L % 4 != 0: a quad would straddle two rows."""
    tab, idx = _gather_inputs(dev, shape, axis, reps, seed=3)
    assert _gather_path(tab, idx, axis, reps) == "scalar"


@pytest.mark.parametrize("shape", [(2303, 128), (5, 128), (1001, 12),
                                   (7, 4)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 2, 32])
def test_dyngather_ragged_row_blocks_stay_on_the_vector_path(
        dev, shape, axis, reps):
    """Row counts that are not a multiple of an axis-1 block's rows (8 at
    L = 128, 85 at L = 12) or are fewer: the last block copies only the
    rows that are left."""
    tab, idx = _gather_inputs(dev, shape, axis, reps, seed=4)
    assert _gather_path(tab, idx, axis, reps) == "vector"


@pytest.mark.parametrize("tab_offset,idx_offset", [(1, 0), (0, 3), (2, 2)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 32])
def test_dyngather_misaligned_views_take_the_scalar_path(
        dev, tab_offset, idx_offset, axis, reps):
    tab, idx = _gather_inputs(dev, (300, 128), axis, reps, seed=5,
                              tab_offset=tab_offset, idx_offset=idx_offset)
    assert tab.is_contiguous() and idx.is_contiguous()
    assert _gather_path(tab, idx, axis, reps) == "scalar"


@pytest.mark.parametrize("S,offset,path", [(3, 0, "vector"), (1, 0, "vector"),
                                           (3, 1, "scalar")])
@pytest.mark.parametrize("reps", [1, 2, 32])
def test_dyngather_axis1_at_the_widest_row(dev, S, offset, path, reps):
    """L = 12288, the widest row axis 1 takes: 48 KB of shared memory a
    block on either path, beside the vector path's mbarrier."""
    tab, idx = _gather_inputs(dev, (S, tdg.MAX_ROW), 1, reps, seed=6,
                              tab_offset=offset)
    assert _gather_path(tab, idx, 1, reps) == path


# ----------------------------------------------------------------------------
# The captured train step (make_train_multi_step) and the selection's device
# route, on the card.
# ----------------------------------------------------------------------------

SMALL = {
    "2d": ((5, 48, 64), 150.0, (0.05, 0.035, 0.03),
           dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
                volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
                gaussian_mode="2d", gaussian_config={"view_anchored": True},
                holdout_views=[1], volume_fill_color=0.38)),
    "3d": ((3, 32, 32), 60.0, (0.09, 0.07, 0.06),
           dict(ell=0.3, grid_size=16, min_n=32, max_n=512,
                volume_idx=[[0, 16]] * 3, num_unets=2, base_filters=4,
                gaussian_mode="3d", holdout_views=[1],
                volume_fill_color=0.38)),
}


def _small_run(dev, mode, **extra):
    """A small model of ``mode`` (with the keyword arguments ``extra``) at
    the trainer's fresh start, its frames stacked, and the index triples of
    8 steps."""
    from pose_splatter_torch.models.pose_splatter import (
        PoseSplatter,
        init_means2d_center,
    )
    from pose_splatter_torch.models.unet3d import init_unet_primary_skip
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import (
        ring_cameras,
        synthetic_frames,
    )

    (C, H, W), focal, axes, kw = SMALL[mode]
    Ks, Es = ring_cameras(C, W, H, focal=focal, radius=0.6)

    def model():
        m = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device=dev,
                         seed=0, **kw, **extra)
        init_unet_primary_skip(m.net, in_channels=m.in_channels)
        if mode == "2d":
            init_means2d_center(m.net, W, H, anchored=True)
        return m

    grid = create_3d_grid(kw["ell"], kw["grid_size"], kw["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0), axes,
                              n_frames=3, seed=0)
    obs = [v for v in range(C) if v not in kw["holdout_views"]]
    stack = dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                 p_3d=frames["p_3d"], angle=frames["angle"])
    rng = np.random.default_rng(1)
    pos = rng.integers(len(obs), size=8)
    idx = (rng.integers(3, size=8), np.asarray(obs)[pos], pos)
    return model, stack, idx


@pytest.fixture
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms for one test: its
    default choices add some convolution gradients in an order that
    changes from run to run, which moves the result of two eager runs
    apart by an ulp as well."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_captured_step_matches_the_eager_step(dev, deterministic_cudnn, mode):
    """Two calls of 4 steps (three eager warm-up steps, the capture, then
    replays) against 8 make_train_step calls on a twin from the same
    weights, both with capturable Adam: the same kernels on the same
    inputs, so with deterministic convolutions the losses, parameters and
    statistics are equal bit for bit. The compositors launch once a
    replay, counted at the capture: the second call, all replays, goes
    through no wrapper, the profiler sees each compositor's last kernel
    at least once a replay, and the call leaves no more than its metrics
    allocated outside the graph's pool."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pose_splatter_torch.train.loop import (
        create_train_state,
        make_train_multi_step,
        make_train_step,
    )

    model, stack, idx = _small_run(dev, mode)
    a, b = model(), model()
    sa, sb = create_train_state(a, 1e-3), create_train_state(b, 1e-3)
    ms = make_train_multi_step(a, sa.optimizer, 0.5, 0.1, stack,
                               steps_per_call=4)
    step = make_train_step(b, sb.optimizer, 0.5, 0.1)
    graph_losses, eager_losses = [], []
    sa, _ = ms(sa, *(x[:4] for x in idx))
    graph_losses += ms.step_metrics["total"].tolist()
    torch.cuda.synchronize()
    wrappers = (tk.composite_instances.launches,
                tk.composite_instances_bwd.launches)
    allocated = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sa, _ = ms(sa, *(x[4:] for x in idx))
        torch.cuda.synchronize()
    graph_losses += ms.step_metrics["total"].tolist()
    assert (tk.composite_instances.launches,
            tk.composite_instances_bwd.launches) == wrappers
    assert torch.cuda.memory_allocated() - allocated <= 4096
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None) == DeviceType.CUDA]
    assert sum("fwd_sum" in n for n in names) >= 4
    assert sum("bwd_grad" in n for n in names) >= 4
    for k in range(8):
        f = idx[0][k]
        batch = {n: v[f:f + 1] for n, v in stack.items()}
        batch.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
        sb, m = step(sb, batch)
        eager_losses.append(float(m["total"]))
    assert ms.replays == 5 and sa.step == sb.step == 8
    assert ms.graph_launches == {"composite_fwd": 1, "composite_bwd": 1,
                                 "carve_visibility": 1}
    assert graph_losses == eager_losses, (graph_losses, eager_losses)
    for (k, x), y in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(x, y), (k, float((x - y).abs().max()))
    assert not bool(a.selection_miss) and not bool(b.selection_miss)


def test_captured_step_raises_on_the_selection_flag(dev):
    """A table miss inside replays is flagged on the device and raised when
    the call returns, never clamped."""
    from pose_splatter_torch.train.loop import (
        create_train_state,
        make_train_multi_step,
    )

    model, stack, idx = _small_run(dev, "2d")
    a = model()
    sa = create_train_state(a, 1e-3)
    ms = make_train_multi_step(a, sa.optimizer, 0.5, 0.1, stack,
                               steps_per_call=4)
    sa, _ = ms(sa, *(x[:4] for x in idx))
    a.selection_miss.fill_(True)  # as a replay's selection would set it
    with pytest.raises(RuntimeError, match="threshold table"):
        ms(sa, *(x[4:] for x in idx))
    assert not bool(a.selection_miss)


def _selection_cases():
    rng = np.random.default_rng(3)
    N = 4096
    cases = [
        (rng.choice([0.0, 2.0, 4.0], N), 1024, 2000),  # ties, up
        (rng.choice([0.0, 2.0, 4.0], N), 2500, 3000),  # ties, down
        (np.concatenate([np.full(2000, 2.0), rng.normal(-3, 1, N - 2000)]),
         500, 1000),  # both loops, a tie at the cap
        (rng.normal(0, 3, N), 100, 300),
        (rng.normal(-6, 1, N), 2000, 4000),
        (np.round(rng.normal(0, 2, N) * 20) / 20, 700, 900),
        (rng.choice([-3.0, 0.0, 2.0], N), 3000, N),  # max_n = N
    ]
    return [(v.astype(np.float32), lo, hi) for v, lo, hi in cases]


@pytest.mark.parametrize("case", range(7))
def test_device_selection_equals_the_host_loops_on_the_card(dev, case):
    from pose_splatter_torch.models.pose_splatter import select_gaussians

    vol0, min_n, max_n = _selection_cases()[case]
    x = torch.from_numpy(vol0).to(dev)
    d = select_gaussians(x, min_n, max_n, 0.25, 0.25, 0.05, route="device")
    h = select_gaussians(x, min_n, max_n, 0.25, 0.25, 0.05, route="host")
    assert not bool(d.table_miss)
    for f in ("indices", "valid", "probs", "mask_threshold"):
        assert torch.equal(getattr(d, f), getattr(h, f)), f
    auto = select_gaussians(x, min_n, max_n, 0.25, 0.25, 0.05)
    assert torch.equal(auto.mask_threshold, d.mask_threshold)


def test_capturable_adam_against_the_eager_update(dev):
    """torch.optim.Adam with capturable=True (which the port builds on the
    card) against capturable=False on the same gradients, 5 steps."""
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = torch.randn(4096, device=dev, generator=gen)
    grads = [torch.randn(4096, device=dev, generator=gen) for _ in range(5)]
    out = {}
    for capturable in (True, False):
        p = p0.clone().requires_grad_(True)
        opt = torch.optim.Adam([p], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                               capturable=capturable)
        for g in grads:
            p.grad = g.clone()
            opt.step()
        out[capturable] = p.detach()
    diff = (out[True] - out[False]).abs()
    ulp = torch.nextafter(out[False].abs(), torch.tensor(np.inf, device=dev)) \
        - out[False].abs()
    print(f"capturable vs eager Adam: {int((diff > 0).sum())} of "
          f"{diff.numel()} entries differ, by at most "
          f"{float((diff / ulp).max()):.3g} ulp")
    # Not the same bits (H100: 1549 of 4096 entries differ). The capturable
    # update takes its bias corrections on the card from float32 betas:
    # 1 - 0.999f**t is 1.3e-5 off 1 - 0.999**t at t = 1, which moves an
    # update by up to 6.4e-6 of itself (through the square root), where
    # the eager update rounds float64 corrections once. Bound: 2 ulp of
    # the parameter plus 2e-5 of the 5 updates' largest sum, 5·lr.
    assert bool((diff <= 2 * ulp + 2e-5 * 5 * 1e-3).all())


# ----------------------------------------------------------------------------
# The bench and the single-device entry; the O(P) compositor on the card.
# ----------------------------------------------------------------------------

BENCH_SMALL = dict(H=48, W=80, N=300)


@pytest.mark.parametrize("entry_point", ["bench3d", "bench2d", "graft_entry"])
def test_new_entry_points_turn_tf32_off(dev, monkeypatch, entry_point):
    """The bench's setups and ``graft_entry.entry`` take the card through
    ``resolve_device``, which turns TF32 off for cuDNN and matmuls."""
    from pose_splatter_torch import graft_entry
    from pose_splatter_torch.scripts import bench

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if entry_point == "graft_entry":
        graft_entry.entry()
    else:
        setup = bench.fwd_bwd_3d if entry_point == "bench3d" else bench.fwd_bwd_2d
        setup(1, device="cuda", **BENCH_SMALL)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("mode", ["3d", "2d"])
@pytest.mark.parametrize("render_mode", ["kernel", "tiled"])
def test_bench_on_the_card_matches_the_cpu(dev, mode, render_mode):
    """The bench's fwd+bwd on the card against the same mode on the CPU,
    gradients within 3e-4 of each tensor's largest entry (see the 3D test
    above for why not the images' 1e-5); kernel mode launches each
    compositor once a frame, tiled mode none."""
    from pose_splatter_torch.scripts import bench

    setup = bench.fwd_bwd_3d if mode == "3d" else bench.fwd_bwd_2d
    outs = []
    for d in ("cuda", "cpu"):
        fn, args = setup(2, render_mode, d, **BENCH_SMALL)
        fwd, bwd = tk.composite_instances.launches, tk.composite_instances_bwd.launches
        outs.append([g.cpu() for g in fn(*args)])
        launched = (tk.composite_instances.launches - fwd,
                    tk.composite_instances_bwd.launches - bwd)
        frames = 2 if mode == "2d" else 1
        expect = ((frames, frames) if d == "cuda" and render_mode == "kernel"
                  else (0, 0))
        assert launched == expect
    for a, b in zip(*outs):
        assert float(b.abs().max()) > 0
        assert ((a - b).abs() <= 3e-4 * b.abs().max()).all()


@pytest.mark.parametrize("mode", ["3d", "2d"])
@pytest.mark.parametrize("render_mode", ["kernel", "tiled"])
def test_bench_device_time_captures(dev, mode, render_mode):
    """``device_ms`` comes from a CUDA graph of one fwd+bwd: the capture
    must take every launch of either mode (a capture that fails raises)."""
    from pose_splatter_torch.scripts import bench

    setup = bench.fwd_bwd_3d if mode == "3d" else bench.fwd_bwd_2d
    fn, args = setup(1, render_mode, "cuda", **BENCH_SMALL)
    ms = bench.graph_device_ms(fn, args, replays=3)
    assert 0 < ms < 1e3


@pytest.mark.parametrize("kind", ["ellipse", "conic"])
def test_composite_pixels_on_the_card_matches_ref(dev, kind):
    """The O(P) Function against autograd through the scan on the card:
    the same forward bit for bit, gradients within 1e-5 of the largest."""
    gen = torch.Generator().manual_seed(3)
    n, P = 200, 1024
    xs = (torch.rand(P, generator=gen) * 64).to(dev)
    ys = (torch.rand(P, generator=gen) * 16).to(dev)
    mean = torch.stack([torch.rand(n, generator=gen) * 64,
                        torch.rand(n, generator=gen) * 16], 1)
    if kind == "ellipse":
        feats = (mean, torch.rand(n, 2, generator=gen) * 2 + 0.5,
                 torch.rand(n, generator=gen) * 3,
                 torch.rand(n, generator=gen) * 0.6 + 0.3)
        alpha_fn, early = tr._alpha_ellipse, False
    else:
        feats = (mean, torch.rand(n, 3, generator=gen) * torch.tensor(
            [0.4, 0.05, 0.4]) + torch.tensor([0.2, -0.025, 0.2]),
            torch.rand(n, generator=gen) * 0.6 + 0.3)
        alpha_fn, early = tr._alpha_conic, True
    colors = torch.rand(n, 3, generator=gen)
    valid = torch.rand(n, generator=gen) > 0.2
    w = torch.rand(P, 3, generator=gen).to(dev)
    outs = []
    for fn in (tr.composite_pixels, tr.composite_pixels_ref):
        f = [x.to(dev).requires_grad_() for x in feats]
        c = colors.to(dev).requires_grad_()
        rgb, alpha = fn(xs, ys, tuple(f), c, valid.to(dev), alpha_fn, 32,
                        early)
        ((rgb * w).sum() + (alpha ** 2).sum()).backward()
        outs.append([rgb.detach(), alpha.detach()]
                    + [x.grad for x in f] + [c.grad])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][2:], outs[1][2:]):
        assert ((a - b).abs() <= 1e-5 * b.abs().max()).all()


def _carve_scene(adaptive):
    """A 4-camera frame of an ellipsoid off the crop's centre and its carve
    arguments (numpy), with the adaptive ``temp_K`` where asked."""
    from pose_splatter_torch.utils.cameras import adjust_principal_points_to_seed
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    C, H, W = 4, 96, 128
    Ks, Es = ring_cameras(C, W, H, focal=200.0, radius=0.6)
    grid = create_3d_grid(0.3, 32, [[0, 32]] * 3)
    f = synthetic_frames(Ks, Es, H, W,
                         grid.reshape(-1, 3).mean(0) + [0.02, -0.01, 0.01],
                         (0.07, 0.05, 0.04), n_frames=1, seed=0)
    K_mask = None
    if adaptive:
        K_mask = adjust_principal_points_to_seed(f["mask"][0], Ks, Es)[0]
        K_mask = K_mask.astype(np.float32)
    return (f["mask"][0], f["img"][0], f["p_3d"][0], f["angle"][:1][0], grid,
            K_mask, Ks, Es)


@pytest.mark.parametrize("cap,adaptive", [(None, False), ("fits", False),
                                          ("overflows", False),
                                          ("overflows", True)])
def test_capped_carve_on_the_card_matches_the_cpu(dev, cap, adaptive):
    """``carve_volume`` with a cap that fits, one that overflows and none,
    and with an adaptive ``K_mask``, on the card against the CPU: the
    occupancy and the overflow exact, the colours within 1e-6 (the colour
    einsum reduces in another order on each device); the occupancy that of
    the uncapped carve whatever the cap. Precondition, as in the CPU parity
    test: both devices round every voxel's projection to the same
    pixel."""
    from pose_splatter_torch.ops import carving as tc
    from pose_splatter_torch.utils import geometry as tg

    args = _carve_scene(adaptive)
    mask = args[0]
    occupied = None
    out = []
    for d in (torch.device("cpu"), dev):
        t = [None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=d) for a in args]
        pts = tg.transform_grid(t[4], t[2], t[3]).reshape(-1, 3)
        flat = tc._pixel_indices(tg.project_points(pts, t[6], t[7], clamp_z=True),
                                 mask.shape[1], mask.shape[2])[2]
        if occupied is None:
            vol = tc.carve_volume(*t, visibility_cap=None)
            occupied = int((vol[0] > 0).sum())
        M = {None: None, "fits": occupied, "overflows": occupied // 3}[cap]
        vol, ovf = tc.carve_volume(*t, visibility_cap=M, return_overflow=True)
        exact = tc.carve_volume(*t)
        out.append((flat.cpu(), vol.cpu(), int(ovf), exact.cpu()))
    (f0, v0, o0, e0), (f1, v1, o1, e1) = out
    assert torch.equal(f0, f1)
    assert o0 == o1 and (o1 > 0) == (cap == "overflows")
    assert torch.equal(v0[0], v1[0]) and torch.equal(v1[0], e1[0])
    assert float((v0 - v1).abs().max()) <= 1e-6
    if cap != "overflows":
        assert float((v1 - e1).abs().max()) <= 1e-6


def test_remat_step_on_the_card_matches_no_remat(dev, deterministic_cudnn):
    """Two train steps of a remat model on the card against its twin
    without remat: with deterministic convolutions the recomputed U-Net
    runs the same kernels on the same inputs, so the losses, parameters
    and statistics are equal bit for bit."""
    from pose_splatter_torch.train.loop import create_train_state, make_train_step

    runs = []
    for remat in (False, True):
        model, stack, idx = _small_run(dev, "2d", remat_unets=remat)
        m = model()
        assert m.net.remat is remat
        state = create_train_state(m, 1e-3)
        step = make_train_step(m, state.optimizer, 0.5, 0.1)
        losses = []
        for k in range(2):
            f = idx[0][k]
            batch = {n: v[f:f + 1] for n, v in stack.items()}
            batch.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
            state, met = step(state, batch)
            losses.append(float(met["total"]))
        runs.append((losses, m.net.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, x in runs[0][1].items():
        assert torch.equal(x, runs[1][1][k]), k


def test_captured_cap_remat_step_matches_the_eager_step(dev, deterministic_cudnn):
    """``make_train_multi_step`` captures a step of a model with the carve's
    visibility cap (small enough to overflow) and ``remat_unets``: its
    replays against eager steps of a twin, bit for bit, as in
    ``test_captured_step_matches_the_eager_step``."""
    from pose_splatter_torch.train.loop import (
        create_train_state,
        make_train_multi_step,
        make_train_step,
    )

    model, stack, idx = _small_run(dev, "2d", carve_visibility_cap=256,
                                   remat_unets=True)
    a, b = model(), model()
    sa, sb = create_train_state(a, 1e-3), create_train_state(b, 1e-3)
    ms = make_train_multi_step(a, sa.optimizer, 0.5, 0.1, stack,
                               steps_per_call=4)
    step = make_train_step(b, sb.optimizer, 0.5, 0.1)
    graph_losses, eager_losses = [], []
    for call in range(2):
        sa, _ = ms(sa, *(x[4 * call:4 * call + 4] for x in idx))
        graph_losses += ms.step_metrics["total"].tolist()
    for k in range(8):
        f = idx[0][k]
        batch = {n: v[f:f + 1] for n, v in stack.items()}
        batch.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
        sb, m = step(sb, batch)
        eager_losses.append(float(m["total"]))
    from pose_splatter_torch.ops.carving import carve_volume

    _, overflow = carve_volume(
        *(a._tensor(stack[k][0]) for k in ("mask", "img", "p_3d", "angle")),
        a.grid, None, a.Ks_obs, a.viewmats_obs, visibility_cap=256,
        return_overflow=True)
    assert int(overflow) > 0  # the captured carve overflows its cap
    assert ms.replays == 5 and ms.graph_launches == {"composite_fwd": 1,
                                                     "composite_bwd": 1,
                                                     "carve_visibility": 1}
    assert graph_losses == eager_losses, (graph_losses, eager_losses)
    for (k, x), y in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(x, y), (k, float((x - y).abs().max()))


def test_final_unet_backward_is_autotuned(dev):
    """The final Unet3D at the presets' crop (96×80×64), one train-mode
    step's backward after a warm-up step: with cuDNN's autotuning, which
    ``resolve_device`` turns on, cuDNN's direct ``wgrad2d_grouped_direct``
    kernel takes under 1 ms of the backward (about 44 ms under the
    heuristic's choice on an H100; autotuning keeps it only where it is the
    fastest candidate, on ``upconv2``'s small weight gradient), and the
    backward's device time stays under 30 ms (about 55 ms under the
    heuristic)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pose_splatter_torch.models.unet3d import Unet3D
    from pose_splatter_torch.utils.device import resolve_device

    resolve_device(dev)
    assert torch.backends.cudnn.benchmark and not torch.backends.cudnn.allow_tf32
    gen = torch.Generator(device=dev).manual_seed(0)
    net = Unet3D(4, 8, 8, input_size=(96, 80, 64)).to(dev)
    x = torch.rand(1, 4, 96, 80, 64, device=dev, generator=gen)

    def loss():
        return net(x, {}).square().mean()

    loss().backward()  # the warm-up step times cuDNN's candidates
    out = loss()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out.backward()
        torch.cuda.synchronize()
    ops = [ev for ev in prof.events()
           if getattr(ev, "device_type", None) == DeviceType.CUDA]
    ms = sum(ev.time_range.elapsed_us() for ev in ops) / 1e3
    direct_ms = sum(ev.time_range.elapsed_us() for ev in ops
                    if "wgrad2d_grouped_direct" in ev.name) / 1e3
    print(f"final U-Net backward: {ms:.3f} ms on the card, "
          f"{direct_ms:.3f} ms of it on the direct kernel")
    assert ops
    assert direct_ms < 1.0, direct_ms
    assert ms < 30.0, ms


# ----------------------------------------------------------------------------
# Preprocessing and the visual-pose features on the card.
# ----------------------------------------------------------------------------

def test_resnet18_on_the_card_matches_the_cpu(dev):
    """ResNet18 (Flax's initialisers from one generator) on 2 images of
    224² on the card against the CPU, within 1e-4 of the largest |feature|
    (cuDNN float32 convolutions, TF32 off)."""
    from pose_splatter_torch.models.resnet import create_feature_extractor

    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    outs = []
    for d in ("cpu", dev):
        extract, _ = create_feature_extractor(
            None, d, torch.Generator().manual_seed(1))
        outs.append(extract(x.to(d)).cpu())
    assert not torch.backends.cudnn.allow_tf32
    assert outs[0].shape == (2, 512)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * float(outs[0].abs().max())


def _lpips_npz(path, seed=0):
    """The JAX package's LPIPS ``.npz`` layout with random weights."""
    from pose_splatter_torch.ops.lpips import _ALEX_CFG

    rng = np.random.default_rng(seed)
    d, cin = {}, 3
    for i, (f, k, _, _) in enumerate(_ALEX_CFG):
        d[f"conv{i}_kernel"] = rng.normal(0, (cin * k * k) ** -0.5,
                                          (k, k, cin, f)).astype(np.float32)
        d[f"conv{i}_bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        d[f"lin{i}"] = rng.uniform(0, 1, f).astype(np.float32)
        cin = f
    np.savez(path, **d)
    return str(path)


def test_lpips_on_the_card_matches_the_cpu(dev, tmp_path):
    """LPIPS on 3 image pairs of 96x128 on the card against the CPU, rtol
    1e-4."""
    from pose_splatter_torch.ops.lpips import create_lpips

    path = _lpips_npz(tmp_path / "lpips.npz")
    gen = torch.Generator().manual_seed(2)
    x, y = torch.rand(2, 3, 96, 128, 3, generator=gen)
    ref = create_lpips(path, device="cpu")(x, y)
    got = create_lpips(path, device=dev)(x.to(dev), y.to(dev)).cpu()
    assert got.shape == (3,) and bool((ref > 0).all())
    assert torch.allclose(got, ref, rtol=1e-4, atol=0)


def _rig_run(dev):
    """The small 3D model on ``dev`` and the rig's frame function (L = 1:
    8 views at 224²), ResNet18 from one generator seed."""
    from pose_splatter_torch.models.pose_splatter import PoseSplatter
    from pose_splatter_torch.preprocess.visual_features import make_frame_features
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    (C, H, W), focal, axes, kw = SMALL["3d"]
    Ks, Es = ring_cameras(C, W, H, focal=focal, radius=0.6)
    model = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device=dev, seed=0,
                         **kw)
    grid = create_3d_grid(kw["ell"], kw["grid_size"], kw["volume_idx"])
    f = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0), axes,
                         n_frames=1, seed=0)
    obs = model.observed_views
    frame = (f["mask"][0, obs], f["img"][0, obs], f["p_3d"][0],
             np.float32(f["angle"][0]), np.float32(0.7))
    fn = make_frame_features(model, 1, None, torch.Generator().manual_seed(3))
    return fn, frame


def test_visual_features_on_the_card_match_the_cpu(dev):
    """One frame's features (carve → U-Nets → Gaussians → the rig through
    the forward kernel → ResNet18 → |A·f|) on the card against the CPU's
    plain path, within 1e-4 of the largest; one compositor launch a
    frame."""
    outs, launches = [], None
    for d in ("cpu", dev):
        fn, frame = _rig_run(d)
        before = tk.composite_instances.launches
        outs.append(fn(*frame).cpu())
        if d is dev:
            launches = tk.composite_instances.launches - before
    assert outs[0].shape == (4, 512)
    assert launches == 1
    err = float((outs[0] - outs[1]).abs().max())
    assert err <= 1e-4 * float(outs[0].abs().max()), err


def test_forward_kernel_on_the_rig_arrays(dev):
    """The forward compositor against its plain version on the instance
    arrays that a rig render binned (8 views x 28 x 2 tiles of (8, 128);
    the second column of tiles partly off the 224-pixel image)."""
    fn, frame = _rig_run(dev)
    with stages.record(dev) as rec:
        fn(*frame)
    b = rec.values["binning"][0]
    assert b.counts.numel() == 8 * 28 * 2 and int(b.counts.sum()) > 0
    args = (b.inst, b.astarts, b.counts, b.origins, tr.DEFAULT_TILE,
            tr.DEFAULT_CHUNK, "conic")
    rgb, alpha, jstop = tk.composite_instances(*args)
    ref = tk.composite_instances_ref(*args)
    assert torch.equal(jstop, ref[2])
    assert float((rgb - ref[0]).abs().max()) <= TOL
    assert float((alpha - ref[1]).abs().max()) <= TOL


@pytest.mark.parametrize("per_frame_K", [False, True])
def test_preprocessing_carves_on_the_card_match_the_cpu(dev, per_frame_K):
    """``_carve_moments_batch`` and ``_occupancy_batch`` on 4 frames of 4
    views at grid 48 on the card against the CPU: occupancy exactly, the
    moments at rtol 1e-5 (of the grid's scale for the means)."""
    from pose_splatter_torch.preprocess.center_rotation import _carve_moments_batch
    from pose_splatter_torch.preprocess.crop_indices import _occupancy_batch
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    B, C, H, W = 4, 4, 96, 128
    Ks, Es = ring_cameras(C, W, H, focal=220.0, radius=1.0)
    f = synthetic_frames(Ks, Es, H, W, np.zeros(3), (0.12, 0.08, 0.07), B, seed=0)
    grid = create_3d_grid(0.4, 48)
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 0.01, (B, 3)).astype(np.float32)
    angles = rng.uniform(-3, 3, B).astype(np.float32)
    K = np.repeat(Ks[None], B, 0) if per_frame_K else Ks
    if per_frame_K:
        K[:, :, :2, 2] += rng.uniform(-2, 2, (B, C, 2)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        t = [torch.as_tensor(a, device=d) for a in
             (f["mask"], centers, grid, K, Es, angles)]
        mean, cov = _carve_moments_batch(*t[:5], carve_threshold=0.75)
        occ = _occupancy_batch(t[0], t[1], t[5], t[2], t[3], t[4],
                               carve_threshold=0.75)
        outs.append((mean.cpu(), cov.cpu(), occ.cpu()))
    (m0, c0, o0), (m1, c1, o1) = outs
    assert torch.equal(o0, o1) and int(o0.max()) == B
    assert torch.allclose(m1, m0, rtol=1e-5, atol=1e-5 * float(np.abs(grid).max()))
    assert torch.allclose(c1, c0, rtol=1e-5, atol=1e-5 * float(c0.abs().max()))


# ---- the carve's visibility kernel (csrc/carve_visibility.cu) ----------

def _vis_inputs(dev, shape, sets):
    from pose_splatter_torch.scripts import dbg_carve_micro as cm

    _, grid_size, crop, width, height = {s[0]: s for s in cm.VIS_SHAPES}[shape]
    return cm.visibility_inputs(dev, grid_size, crop, width, height, sets)


def _pair_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("sets", ["ellipsoid", "random"])
@pytest.mark.parametrize("shape", ["2d_576x512", "3d_288x256",
                                   "highres_1152x1024"])
def test_carve_visibility_kernel_equals_plain(dev, shape, sets):
    """The kernel at the main path's three carve shapes (5 ring cameras;
    the benchmark scene's ellipsoid, and random sets that are not nested)
    against its plain version on the card, bit for bit, one launch a
    call, the same booleans on a rerun; at the two smaller shapes also
    against the plain version on the CPU."""
    from pose_splatter_torch.ops import carving as tc

    x = _vis_inputs(dev, shape, sets)
    before = tc.ray_cast_visibility_pair.launches
    got = tc.ray_cast_visibility_pair(*x)
    torch.cuda.synchronize()
    assert tc.ray_cast_visibility_pair.launches == before + 1
    assert got[0].any() and got[1].any()
    assert _pair_equal(got, tc.visibility_pair_ref(*x))
    assert _pair_equal(got, tc.ray_cast_visibility_pair(*x))
    if shape != "highres_1152x1024":
        cpu = tc.visibility_pair_ref(*(a.cpu() for a in x[:4]), x[4])
        assert _pair_equal([v.cpu() for v in got], cpu)


def test_carve_visibility_kernel_under_graph_capture(dev):
    """One call captured in a CUDA graph (counted once, at the capture):
    replays on new inputs copied into the captured ones give the eager
    call's booleans on those inputs."""
    from pose_splatter_torch.ops import carving as tc

    x = _vis_inputs(dev, "2d_576x512", "ellipsoid")
    y = _vis_inputs(dev, "2d_576x512", "random")
    eager_x, eager_y = tc.ray_cast_visibility_pair(*x), tc.ray_cast_visibility_pair(*y)
    static = [a.clone() for a in y[:4]]
    torch.cuda.synchronize()
    before = tc.ray_cast_visibility_pair.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tc.ray_cast_visibility_pair(*static, x[4])
    assert tc.ray_cast_visibility_pair.launches == before + 1
    for inputs, want in ((x, eager_x), (y, eager_y)):
        for s, a in zip(static, inputs[:4]):
            s.copy_(a)
        graph.replay()
        torch.cuda.synchronize()
        assert _pair_equal(out, want)
    assert tc.ray_cast_visibility_pair.launches == before + 1


@pytest.mark.parametrize("cap", [None, "overflows"])
def test_carve_volume_through_the_kernel(dev, monkeypatch, cap):
    """``carve_volume`` on the card launches the kernel once a carve (the
    CPU none), its visibility equals the plain version's on the carve's
    own arguments, and its volume equals, bit for bit, the card's volume
    with the plain version in the kernel's place; against the CPU's volume
    the occupancy is exact and the colours within 1e-6 (the colour einsum
    and the distances round in another order on each device)."""
    from pose_splatter_torch.ops import carving as tc

    calls = []
    wrapper = tc.ray_cast_visibility_pair

    def recorded(*a):
        out = wrapper(*a)
        calls.append((a, out))
        return out

    # The wrapper counts its launches on the module's name for it.
    recorded.launches = 0
    monkeypatch.setattr(tc, "ray_cast_visibility_pair", recorded)
    args = _carve_scene(False)
    vols, counted = [], []
    for d in (torch.device("cpu"), dev):
        t = [None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=d) for a in args]
        M = None if cap is None else 200
        before = recorded.launches
        vols.append(tc.carve_volume(*t, visibility_cap=M).cpu())
        counted.append(recorded.launches - before)
    assert counted == [0, 1]
    (a, out) = calls[-1]
    assert out[0].is_cuda and _pair_equal(out, tc.visibility_pair_ref(*a))
    monkeypatch.setattr(tc, "ray_cast_visibility_pair",
                        lambda *a: tc.visibility_pair_ref(*a[:4], a[4]))
    plain = tc.carve_volume(*t, visibility_cap=M).cpu()
    assert torch.equal(vols[1], plain)
    assert torch.equal(vols[0][0], vols[1][0])
    assert float((vols[0] - vols[1]).abs().max()) <= 1e-6


@pytest.mark.parametrize("method", ["sort", "segment"])
def test_ray_cast_visibility_on_the_card_matches_the_cpu(dev, method):
    """``ray_cast_visibility`` on the card against the CPU, bit for bit,
    on a 32³ grid of (k - 15.5)/32 coordinates whose occupied voxels form
    a ball, seen by 4 cameras a quarter turn apart about y at distance 2
    with f = 64 on 64x64 images: every coordinate, product and sum of the
    projection and the distances is exact in float32, and the division and
    square root round alike on both devices."""
    from pose_splatter_torch.ops import carving as tc

    g = (torch.arange(32, dtype=torch.float32) - 15.5) / 32
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    occ = (pts ** 2).sum(-1) < 0.35 ** 2
    Es = torch.zeros((4, 4, 4))
    for i, (c, s) in enumerate(((1, 0), (0, 1), (-1, 0), (0, -1))):
        Es[i, :3, :3] = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                     dtype=torch.float32)
        Es[i, 2, 3], Es[i, 3, 3] = 2.0, 1.0
    Ks = torch.tensor([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]]).expand(4, 3, 3)
    cpu = tc.ray_cast_visibility(pts, occ, Ks, Es, 64, 64, method)
    card = tc.ray_cast_visibility(*(x.to(dev) for x in (pts, occ, Ks, Es)),
                                  64, 64, method)
    assert int(cpu.sum()) > 0 and torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("case", ["dists_dtype", "flat_dtype", "occ_shape",
                                  "not_contiguous", "too_many_voxels"])
def test_carve_visibility_wrapper_rejects_what_the_kernel_does_not_take(
        dev, case):
    """The wrapper's checks on CUDA tensors, and a CPU tensor beside a CUDA
    one; nothing is launched."""
    from pose_splatter_torch.ops import carving as tc

    d = torch.ones((2, 8), device=dev)
    f = torch.zeros((2, 8), dtype=torch.long, device=dev)
    o = torch.ones(8, dtype=torch.bool, device=dev)
    bad = {"dists_dtype": (d.double(), f, o, o),
           "flat_dtype": (d, f.int(), o, o),
           "occ_shape": (d, f, o[:7], o),
           "not_contiguous": (d, torch.zeros((8, 2), dtype=torch.long,
                                             device=dev).T, o, o),
           "too_many_voxels": (torch.empty((0, 1 << 32), device=dev), f, o,
                               o)}[case]
    before = tc.ray_cast_visibility_pair.launches
    with pytest.raises((TypeError, ValueError)):
        tc.ray_cast_visibility_pair(*bad, 16)
    with pytest.raises(ValueError, match="is on cpu"):
        tc.ray_cast_visibility_pair(d, f.cpu(), o, o, 16)
    assert tc.ray_cast_visibility_pair.launches == before
