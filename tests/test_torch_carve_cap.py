"""The carve's ``visibility_cap`` path and the adaptive camera's ``K_mask``
in the port against the JAX package's ``carve_volume``, at a small size
(4 cameras of 64×48, a 16³ crop of a 32 grid).

``compact_occupied`` is held bit for bit: the same voxel ids and overflow.
The carve is held within 1e-6 with the occupancy channel and the overflow
exact, as the JAX package holds its own capped carve against its exact one
(``tests/test_carving.py``): the ``[C, M]`` colour einsum reduces in
another order than the ``[C, N]`` one, and torch's einsum in another order
than XLA's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.ops import carving as jcarv
from pose_splatter_tpu.utils import cameras as jcams
from pose_splatter_torch.ops import carving as tcarv
from pose_splatter_torch.utils import cameras as tcams
from pose_splatter_torch.utils import geometry as tgeo
from test_torch_geometry_carving import _cams, _frame

torch.set_num_threads(1)

N = 16 ** 3
CENTER = np.array([0.004, -0.003, 0.002], np.float32)


@pytest.mark.parametrize("p,cap", [
    (0.3, 64), (0.3, 4096), (0.02, 4096), (0.0, 16), (1.0, 4096), (0.5, 1)])
def test_compact_occupied_equals_jax(p, cap):
    """Occupancy masks of every density, caps below, at and above the
    occupied count: ``comp`` (N marks an empty slot) and the overflow."""
    occ = np.random.default_rng(int(p * 100) + cap).random(N) < p
    jcomp, jovf = jcarv.compact_occupied(jnp.asarray(occ), cap)
    tcomp, tovf = tcarv.compact_occupied(torch.from_numpy(occ), cap)
    np.testing.assert_array_equal(np.asarray(jcomp), tcomp.numpy())
    assert int(jovf) == int(tovf) == max(int(occ.sum()) - cap, 0)
    assert tcomp.shape == (cap,)


def _carve_both(cap, adaptive=False, angle=0.4):
    Ks, Es = _cams()
    masks, imgs = _frame()
    grid = tgeo.create_3d_grid(1.2, 32, [[8, 24]] * 3)
    K_mask = None
    if adaptive:
        K_mask, seed = tcams.adjust_principal_points_to_seed(masks, Ks, Es)
        jK, jseed = jcams.adjust_principal_points_to_seed(masks, Ks, Es)
        np.testing.assert_array_equal(K_mask, jK)
        np.testing.assert_array_equal(seed, jseed)
        K_mask = K_mask.astype(np.float32)
        assert np.abs(K_mask - Ks).max() > 0.1  # the principal points moved
    ref, rovf = jcarv.carve_volume(
        jnp.asarray(masks), jnp.asarray(imgs), jnp.asarray(CENTER),
        jnp.float32(angle), jnp.asarray(grid),
        None if K_mask is None else jnp.asarray(K_mask), jnp.asarray(Ks),
        jnp.asarray(Es), volume_fill_color=0.38, visibility_cap=cap,
        return_overflow=True)
    got, tovf = tcarv.carve_volume(
        torch.from_numpy(masks), torch.from_numpy(imgs),
        torch.from_numpy(CENTER), torch.tensor(angle, dtype=torch.float32),
        torch.from_numpy(grid),
        None if K_mask is None else torch.from_numpy(K_mask),
        torch.from_numpy(Ks), torch.from_numpy(Es), volume_fill_color=0.38,
        visibility_cap=cap, return_overflow=True)
    return np.asarray(ref), int(rovf), got.numpy(), int(tovf)


def _occupied(ref):
    return int((ref[0] > 0).sum())


@pytest.mark.parametrize("case", ["fits", "overflows", "cap_n", "adaptive",
                                  "adaptive_overflows"])
def test_capped_carve_matches_jax(case):
    """A cap that fits, one that overflows, a cap of N (the exact path),
    and a per-frame ``K_mask`` from ``adjust_principal_points_to_seed``
    (the mask's own projection, no z clamp) with a cap that fits and one
    that overflows."""
    exact, _, _, _ = _carve_both(None, adaptive=case.startswith("adaptive"))
    occupied = _occupied(exact)
    assert 0 < occupied < N
    cap = {"fits": occupied + 7, "overflows": occupied // 3, "cap_n": N,
           "adaptive": occupied, "adaptive_overflows": occupied // 2}[case]
    ref, rovf, got, tovf = _carve_both(cap, adaptive=case.startswith("adaptive"))
    assert rovf == tovf
    assert (tovf > 0) == case.endswith("overflows")
    assert got.shape == (4, 16, 16, 16)
    np.testing.assert_array_equal(ref[0], got[0])  # occupancy exact
    np.testing.assert_allclose(ref[1:], got[1:], rtol=0, atol=1e-6)
    if tovf == 0:
        # A cap that fits is the exact carve, within the reduction order.
        np.testing.assert_allclose(exact, got, rtol=0, atol=1e-6)
    else:
        # Overflowed voxels keep the uniform average: colours move only there.
        assert np.abs(exact[1:] - got[1:]).max() > 1e-3


def test_k_mask_moves_only_the_mask_projection():
    """With ``K_mask`` the occupancy follows the shifted intrinsics while
    the colours are sampled through the cameras' own: the adaptive carve
    differs from the shared-intrinsics one, and both match JAX."""
    shared, _, shared_t, _ = _carve_both(None)
    adaptive, _, adaptive_t, _ = _carve_both(None, adaptive=True)
    np.testing.assert_allclose(shared, shared_t, rtol=0, atol=1e-6)
    np.testing.assert_allclose(adaptive, adaptive_t, rtol=0, atol=1e-6)
    assert not np.array_equal(shared[0], adaptive[0])
