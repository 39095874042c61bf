"""The port's CUDA forward compositor against its plain PyTorch version, on
the card: tile shapes and chunk sizes beyond the main path's, empty and
ragged segments, early stop, the launch count and the wrapper's checks.

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
