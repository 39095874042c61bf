"""The port's CUDA forward and backward compositors against their plain
PyTorch versions, on the card: tile shapes and chunk sizes beyond the main
path's, empty and ragged segments, early stop, the forward's ``tbounds``
store, the launch counts and the wrappers' checks.

Every test is marked ``cuda`` and skips where no CUDA device is present
(the kernel has no CPU mode). On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda_kernels.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax, which such a
machine need not have; this file imports only the port.)
"""

import pytest
import torch

from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk

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
