"""The port's novel views (``viz/render_image.py``: ``render_novel_view``,
``render_turntable``) against the JAX package's, at a small size: a 3D
model of 3 cameras at 32×32 (grid 16, up to 512 Gaussians, 2 U-Nets of
width 4) rendered at 64×64 through intrinsics scaled by 2, as the CLIs
render at ``ds = 1``.

Both models get the same weights (seeded numpy values through the bridge)
and the same synthetic frame. ``"global"`` mode on both sides, and the
kernel path: the port's plain compositor against the JAX Pallas kernel in
interpret mode. Images agree within 1e-4.

The scene is ``tests/test_torch_model_3d.py``'s. A new view of it can put
a pixel-Gaussian pair within float32 rounding of a conic gate, where the
two packages may take different branches (ROADMAP C.14): the shift
(0.01, -0.02, 0.005) at offset 0.5 flips the 1/255 skip at one pixel
(2.2e-3 at 3 values), as does view 2 of the turntable at π/2 (2.0e-3)
and view 0 at 3π/2 (1.04e-4). The shift and views here are ones whose
images hold no such pair.

The turn's centroid is the mean over all ``max_n`` slots, invalid ones
included (a property of the reference); this frame's invalid slots pull it
well away from the valid Gaussians' mean, so a port that took the valid
mean would miss the offset-0.5 images.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.models.pose_splatter import select_gaussians
from pose_splatter_tpu.viz import render_image as jri
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.utils.synthetic import ring_cameras
from pose_splatter_torch.viz import render_image as tri
from test_torch_model_3d import C, H, KW, W, _frames
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

DELTA = (0.02, 0.01, -0.01)
MODES = {"global": ("global", "global"), "kernel": ("pallas", "kernel")}


@pytest.fixture(scope="module")
def scene():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    models = {}
    for name, (jmode, tmode) in MODES.items():
        jm = JModel(Ks, Es, W, H, render_mode=jmode, **KW)
        tm = TModel(Ks, Es, W, H, render_mode=tmode, device="cpu", **KW)
        models[name] = (jm, tm)
    variables = random_variables(models["global"][0].net,
                                 jnp.zeros((1, 16, 16, 16, 4)), seed=0,
                                 train=False)
    variables["params"]["scale"] = np.full((1,), np.log(0.03), np.float32)
    for _, tm in models.values():
        tm.net.load_state_dict(variables_from_flax(variables))
    frames = _frames(Ks, Es, 2)
    obs = models["global"][1].observed_views
    inputs = (frames["mask"][0, obs], frames["img"][0, obs],
              frames["p_3d"][0], float(frames["angle"][0]))
    K_full = Ks.copy()
    K_full[:, :2] *= 2.0
    return models, variables, inputs, K_full


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_render_novel_view_matches_jax(scene, mode, offset):
    models, variables, inputs, K_full = scene
    jm, tm = models[mode]
    with pltpu.force_tpu_interpret_mode():
        ref = jri.render_novel_view(jm, variables, *inputs, 2, K_full,
                                    2 * W, 2 * H, angle_offset=offset,
                                    delta_xyz=DELTA)
    got = tri.render_novel_view(tm, *inputs, 2, K_full, 2 * W, 2 * H,
                                angle_offset=offset, delta_xyz=DELTA)
    assert got.shape == (2 * H, 2 * W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert (got.min(-1) < 0.9).sum() > 50  # the animal is in view


def test_centroid_counts_every_slot(scene):
    """The turn's centre is the mean of all max_n slots; here it lies
    about 1 cm from the valid Gaussians' mean, a shift of several pixels
    once turned by 0.5 rad, so the images above tell the two apart."""
    models, _, (mask, img, p_3d, angle), _ = scene
    tm = models["global"][1]
    with torch.no_grad():
        flat = tm.net.process_volume(
            tm.carve(mask, img, p_3d, angle).permute(1, 2, 3, 0)[None])
        g = tm.gaussians_from_volume(flat)
    valid = g["valid"]
    assert 0 < int(valid.sum()) < tm.max_n
    gap = float((g["means"].mean(0) - g["means"][valid].mean(0)).norm())
    assert gap > 5e-3


def test_frame_gaussians_matches_jax(scene):
    """``PoseSplatter.frame_gaussians``, the carve → U-Nets → head sequence
    that the forward, the novel view and the export share, gives the JAX
    head's Gaussians and the voxels its selection picked."""
    models, variables, (mask, img, p_3d, angle), _ = scene
    jm, tm = models["global"]
    jv = jax.tree.map(jnp.asarray, variables)
    jvol = jm.carve(jnp.asarray(mask), jnp.asarray(img), jnp.asarray(p_3d),
                    jnp.float32(angle))
    jflat = jm.net.apply(jv, jnp.transpose(jvol, (1, 2, 3, 0))[None], False,
                         method="process_volume")
    ref = jm.gaussians_from_volume(jv, jflat)
    jsel = select_gaussians(jflat[0], jm.min_n, jm.max_n, jm.prob_threshold,
                            jm.mask_threshold, jm.mask_threshold_delta)
    with torch.no_grad():
        g, indices = tm.frame_gaussians(mask, img, p_3d, angle)
    valid = g["valid"].numpy()
    np.testing.assert_array_equal(np.asarray(ref["valid"]), valid)
    assert int(valid.sum()) >= KW["min_n"]
    np.testing.assert_array_equal(np.asarray(jsel.indices)[valid],
                                  indices.numpy()[valid])
    for k in ("means", "log_scales", "quats", "colors", "logit_opacities"):
        np.testing.assert_allclose(np.asarray(ref[k]), g[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_render_turntable_matches_jax(scene):
    models, variables, inputs, K_full = scene
    jm, tm = models["global"]
    ref = jri.render_turntable(jm, variables, *inputs, 1, K_full, 2 * W,
                               2 * H, n_steps=4)
    got = tri.render_turntable(tm, *inputs, 1, K_full, 2 * W, 2 * H,
                               n_steps=4)
    assert got.shape == (4, 2 * H, 2 * W, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
    # Each step turns the animal: no two views are the same image.
    assert min(np.abs(got[i] - got[j]).max()
               for i in range(4) for j in range(i)) > 0.05
