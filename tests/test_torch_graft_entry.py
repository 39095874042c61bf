"""The port's single-device entry (``pose_splatter_torch/graft_entry.py``)
against ``__graft_entry__.py::entry``, on the CPU.

The JAX entry's weights (``model.init(PRNGKey(0))``) go to the port through
``bridge.variables_from_flax`` and into its ``fn`` as the ``variables``
argument; both forwards run the flagship 3D model in ``"tiled"`` mode on
the entry's own masks and images, and ``rgb`` and ``alpha`` must agree
within 1e-4. The JAX model's ``init`` is run under ``jax.jit`` here (the
same key and initialisers; eager it takes most of a minute); the comparison
does not depend on the weights' last bits, which both sides share. The
scene holds no pixel-Gaussian pair within float32 rounding of a conic gate
(ROADMAP C.14), so no pixel flips.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.graft_entry import _build_model, entry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_entry():
    sys.path.insert(0, str(ROOT))
    try:
        import __graft_entry__ as G
    finally:
        sys.path.remove(str(ROOT))

    def jitted_init(self, rng):
        dummy = jnp.zeros((1, *self.input_size, self.in_channels))
        return jax.jit(lambda r: self.net.init(r, dummy, train=False))(rng)

    mp = pytest.MonkeyPatch()
    mp.setattr(JModel, "init", jitted_init)
    try:
        fn, args = G.entry()
    finally:
        mp.undo()
    rgb, alpha = jax.jit(fn)(*args)
    return args, np.asarray(rgb), np.asarray(alpha)


def test_entry_matches_jax(jax_entry):
    jargs, jrgb, jalpha = jax_entry
    fn, args = entry(device="cpu")
    variables = variables_from_flax(jax.tree.map(np.asarray, jargs[0]))
    assert set(variables) == set(args[0])
    for a, b in zip(jargs[1:], args[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rgb, alpha = fn(variables, *args[1:])
    assert rgb.shape == jrgb.shape == (1, 64, 64, 3)
    assert alpha.shape == jalpha.shape == (1, 64, 64)
    assert float(alpha.max()) > 0.05
    assert np.abs(jrgb - rgb.numpy()).max() <= 1e-4
    assert np.abs(jalpha - alpha.numpy()).max() <= 1e-4


def test_entry_contract():
    """``fn(variables, mask, img, p_3d, angle, view_idx)``: the weights are
    an argument (the model's own stay as they were), eval mode, and the
    JAX entry's model: 3 cameras of 64x64, grid 32, tiled (32, 64)."""
    model, masks, imgs = _build_model(device="cpu")
    assert (model.render_mode, model.tile_shape) == ("tiled", (32, 64))
    assert (model.min_n, model.max_n, model.gaussian_mode) == (64, 1024, "3d")
    assert masks.shape == (3, 64, 64) and imgs.shape == (3, 64, 64, 3)
    fn, args = entry(device="cpu")
    assert len(args) == 6
    variables = args[0]
    before = {k: v.clone() for k, v in variables.items()}
    rgb, alpha = fn(*args)
    shifted = dict(variables, scale=variables["scale"] + 1.0)
    rgb2, _ = fn(shifted, *args[1:])
    assert not torch.equal(rgb, rgb2)
    rgb3, alpha3 = fn(*args)
    assert torch.equal(rgb, rgb3) and torch.equal(alpha, alpha3)
    assert all(torch.equal(before[k], v) for k, v in variables.items())
    assert not rgb.requires_grad
