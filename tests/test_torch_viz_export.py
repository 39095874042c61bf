"""The port's Gaussian export (``viz/export.py``) against the JAX
package's: ``extract_world_gaussians`` on a 3D model with the same
(bridged) weights and frame, the four savers on one dict, and
``export_animation_sequence``; and the 2D model's failure in both.

The model is ``tests/test_torch_model_3d.py``'s (3 cameras at 32×32,
grid 16, up to 512 Gaussians). The valid sets and counts agree exactly,
every parameter array within 1e-5 of its largest entry. The savers are
compared on the same numpy dict, where the files must be byte-identical
(the PLY's integer columns would turn a 1e-7 difference into a unit);
npz archives by their contents (zip entries carry the time of writing).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.viz import export as jex
from pose_splatter_tpu.viz import render_image as jri
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.utils.synthetic import FrameSet, ring_cameras
from pose_splatter_torch.viz import export as tex
from pose_splatter_torch.viz import render_image as tri
from test_torch_model_3d import C, H, KW, W, _frames
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

KEYS = ("means", "quaternions", "scales", "opacities", "colors", "center")


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def scene():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="global", **KW)
    tm = TModel(Ks, Es, W, H, render_mode="global", device="cpu", **KW)
    variables = random_variables(jm.net, jnp.zeros((1, 16, 16, 16, 4)),
                                 seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(0.03), np.float32)
    tm.net.load_state_dict(variables_from_flax(variables))
    frames = _frames(Ks, Es, 2)
    data = FrameSet(frames, tm.observed_views)
    return jm, variables, tm, data


@pytest.mark.parametrize("center_means", [True, False])
def test_extract_world_gaussians_matches_jax(scene, center_means):
    """``center`` is the mean of the valid means only; this frame's
    invalid slots lie elsewhere (see test_torch_render_novel_view.py), so
    the centre is the valid rows' own."""
    jm, variables, tm, data = scene
    inputs = data.get(0, view_idx=0)[:4]
    ref = jex.extract_world_gaussians(jm, variables, *inputs,
                                      center_means=center_means)
    got = tex.extract_world_gaussians(tm, *inputs, center_means=center_means)
    assert sorted(got) == sorted(ref) == sorted(KEYS)
    n = len(ref["means"])
    assert KW["min_n"] <= n < KW["max_n"]
    for k in KEYS:
        assert got[k].shape == np.asarray(ref[k]).shape, k
        assert got[k].dtype == np.float32, k
        _close(got[k], ref[k], k)
    world = got["means"] + (got["center"] if center_means else 0)
    np.testing.assert_allclose(got["center"][0], world.mean(0), atol=1e-7)


@pytest.fixture(scope="module")
def exported(scene):
    jm, variables, _, data = scene
    g = jex.extract_world_gaussians(jm, variables, *data.get(0, view_idx=0)[:4])
    return {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("fmt", ["ply_extended", "ply", "json"])
def test_savers_byte_identical(exported, tmp_path, fmt):
    savers = {"ply_extended": (jex.save_ply_extended, tex.save_ply_extended),
              "ply": (jex.save_ply_pointcloud, tex.save_ply_pointcloud),
              "json": (jex.save_json, tex.save_json)}[fmt]
    jfn, tfn = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    assert savers[0](exported, jfn) == jfn and savers[1](exported, tfn) == tfn
    data = open(tfn, "rb").read()
    assert data == open(jfn, "rb").read()
    assert len(data) > 1000


def test_save_npz_same_contents(exported, tmp_path):
    jex.save_npz(exported, str(tmp_path / "j.npz"))
    tex.save_npz(exported, str(tmp_path / "t.npz"))
    j = np.load(tmp_path / "j.npz", allow_pickle=True)
    t = np.load(tmp_path / "t.npz", allow_pickle=True)
    assert sorted(t.files) == sorted(j.files) == sorted(KEYS + ("metadata",))
    for k in KEYS:
        np.testing.assert_array_equal(t[k], j[k])
    assert t["metadata"].item() == j["metadata"].item()
    assert t["metadata"].item()["num_gaussians"] == len(exported["means"])


def test_export_animation_sequence_matches_jax(scene, tmp_path):
    jm, variables, tm, data = scene
    jpaths = jex.export_animation_sequence(jm, variables, data, range(2),
                                           str(tmp_path / "j"), "npz",
                                           progress=False)
    tpaths = tex.export_animation_sequence(tm, data, range(2),
                                           str(tmp_path / "t"), "npz",
                                           progress=False)
    names = [p.split("/")[-1] for p in tpaths]
    assert names == [p.split("/")[-1] for p in jpaths] == [
        "gaussian_frame0000.npz", "gaussian_frame0001.npz"]
    for jp, tp in zip(jpaths, tpaths):
        j, t = np.load(jp, allow_pickle=True), np.load(tp, allow_pickle=True)
        assert len(t["means"]) == len(j["means"])
        for k in KEYS:
            _close(t[k], j[k], k)


def test_2d_model_has_no_world_gaussians():
    """2D Gaussians carry ``means2d`` (and anchors), not ``means``: export
    and the novel view raise KeyError in both packages."""
    kw = dict(KW, gaussian_mode="2d")
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="global", **kw)
    tm = TModel(Ks, Es, W, H, render_mode="global", device="cpu", **kw)
    variables = random_variables(jm.net, jnp.zeros((1, 16, 16, 16, 4)),
                                 seed=0, train=False)
    tm.net.load_state_dict(variables_from_flax(variables))
    inputs = FrameSet(_frames(Ks, Es, 1), tm.observed_views).get(0, 0)[:4]
    with pytest.raises(KeyError, match="means"):
        jex.extract_world_gaussians(jm, variables, *inputs)
    with pytest.raises(KeyError, match="means"):
        tex.extract_world_gaussians(tm, *inputs)
    with pytest.raises(KeyError, match="means"):
        jri.render_novel_view(jm, variables, *inputs, 0, Ks, W, H)
    with pytest.raises(KeyError, match="means"):
        tri.render_novel_view(tm, *inputs, 0, Ks, W, H)
