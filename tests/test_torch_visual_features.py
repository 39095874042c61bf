"""The port's visual-pose features (``preprocess/visual_features.py``)
against the JAX package's, at a small size: the 3D model at grid 16 with up
to 256 Gaussians (3 cameras of 32×32, 2 U-Nets of width 4, bridged
weights), the rig at L = 1 (2 polar nodes × 4 azimuths = 8 views at
224²), 2 frames, seed 0, ResNet18 weights from one ``.npz`` that both
packages read.

The JAX side renders the rig through its Pallas kernel in interpret mode
(``render_mode="pallas"``), the port through the forward compositor's
plain version (``"kernel"`` mode on CPU tensors). The float32 features
before the cast (taken from inside each package's
``calculate_visual_features``) agree within 1e-4 of the largest, the
float16 outputs within 1 ULP, or 1 ULP plus the float32 pair's difference
where a modulus cancels far below the largest. The Pallas interpret mode
runs the JAX side in about 30 s on one CPU thread, so this file keeps
kernel mode rather than falling back to ``"tiled"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models import resnet as jresnet
from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.preprocess import visual_features as jvf
from pose_splatter_torch.bridge import resnet_from_flax, variables_from_flax
from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.preprocess import visual_features as tvf
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

C, H, W = 3, 32, 32
L = 1
KW = dict(ell=0.3, grid_size=16, min_n=32, max_n=256,
          volume_idx=[[0, 16]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="3d", holdout_views=[1], volume_fill_color=0.38)
AXES = (0.09, 0.07, 0.06)


def test_rig_and_sh_matrix_bit_equal():
    for Lx in (1, 3):
        for a, b in zip(jvf.spherical_rig(Lx), tvf.spherical_rig(Lx)):
            np.testing.assert_array_equal(a, b)
        _, _, thetas, phis, w = tvf.spherical_rig(Lx)
        A = tvf.build_A(Lx, w, thetas, phis)
        assert A.dtype == np.complex64 and A.shape == ((Lx + 1) ** 2, 2 * (Lx + 1) ** 2)
        np.testing.assert_array_equal(A, jvf.build_A(Lx, w, thetas, phis))
    Ks, views, _, _, _ = tvf.spherical_rig(3)
    assert Ks.shape == (32, 3, 3) and views.shape == (32, 4, 4)
    assert abs(Ks[0, 0, 0] - 112 / np.tan(np.deg2rad(3.75))) < 1e-3


def test_sh_invariant_features_match():
    rng = np.random.default_rng(0)
    _, _, thetas, phis, w = tvf.spherical_rig(3)
    A = tvf.build_A(3, w, thetas, phis)
    f = rng.uniform(0, 2, (32, 512)).astype(np.float32)
    ref = np.asarray(jvf.sh_invariant_features(jnp.asarray(f), jnp.asarray(A)))
    got = tvf.sh_invariant_features(torch.from_numpy(f), torch.from_numpy(A))
    assert got.dtype == torch.float32 and got.shape == (16, 512)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    # Gaussians of about 6 mm: 10 px on the rig (f ≈ 1709 px at radius 1).
    variables["params"]["scale"] = np.full((1,), np.log(0.006), np.float32)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    tm.net.load_state_dict(variables_from_flax(variables))
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0), AXES,
                              n_frames=2, seed=0)
    data = FrameSet(frames, tm.observed_views)
    rvars = random_variables(jresnet.ResNet18(), jnp.zeros((1, 64, 64, 3)),
                             seed=1, train=False)
    weights = str(tmp_path_factory.mktemp("resnet") / "resnet18.npz")
    np.savez(weights, **{k: v.numpy() for k, v in resnet_from_flax(rvars).items()})
    return jm, variables, tm, data, weights


def _capture_sh(module, monkeypatch, out):
    """Collect each frame's float32 features, before the float16 cast, from
    inside ``module.calculate_visual_features`` (its call of
    ``sh_invariant_features``; under ``jax.jit`` through a host callback)."""
    orig = module.sh_invariant_features

    def jax_capture(features, A):
        f = orig(features, A)
        jax.debug.callback(lambda x: out.append(np.asarray(x)), f)
        return f

    def torch_capture(features, A):
        f = orig(features, A)
        out.append(f.numpy().copy())
        return f

    monkeypatch.setattr(module, "sh_invariant_features",
                        jax_capture if module is jvf else torch_capture)


def test_visual_features_match_jax(setup, tmp_path, monkeypatch):
    jm, variables, tm, data, weights = setup
    jcfg = Config({"project_directory": str(tmp_path / "jax"), "feature_fn": "f.npy"})
    tcfg = Config({"project_directory": str(tmp_path / "torch"), "feature_fn": "f.npy"})
    for cfg in (jcfg, tcfg):
        (tmp_path / cfg.feature_fn).parent.mkdir()
    ref32, got32 = [], []
    _capture_sh(jvf, monkeypatch, ref32)
    _capture_sh(tvf, monkeypatch, got32)
    with pltpu.force_tpu_interpret_mode():
        ref16 = jvf.calculate_visual_features(jcfg, jm, variables, data,
                                              resnet_weights=weights, L=L,
                                              seed=0, progress=False)
    with stages.record("cpu") as rec:
        got16 = tvf.calculate_visual_features(tcfg, tm, data,
                                              resnet_weights=weights, L=L,
                                              seed=0, progress=False)
    ref32, got32 = np.stack(ref32), np.stack(got32)
    assert got32.shape == ref32.shape == (2, (L + 1) ** 2, 512)
    np.testing.assert_array_equal(ref32.astype(np.float16), ref16)
    np.testing.assert_array_equal(got32.astype(np.float16), got16)
    np.testing.assert_allclose(got32, ref32, rtol=0,
                               atol=1e-4 * float(np.abs(ref32).max()))
    assert got16.dtype == np.float16 and got16.shape == ref16.shape
    np.testing.assert_array_equal(np.load(tcfg.feature_fn), got16)
    # float16 within 1 ULP (the gap to the neighbouring float16), where the
    # float32 pair lies within it. SH moduli that cancel to 1e-5 of the
    # largest keep the float32 pair's absolute difference: there the bound
    # is 1 ULP plus that difference.
    ulp = np.maximum(np.spacing(np.abs(ref16)), np.spacing(np.abs(got16)))
    ulp = ulp.astype(np.float32)
    d16 = np.abs(got16.astype(np.float32) - ref16.astype(np.float32))
    assert np.all(d16 <= ulp + np.abs(got32 - ref32))
    assert np.mean(d16 <= ulp) > 0.99
    # The stages, once a frame; the rig's 8 views x 28 x 2 tiles hold
    # instances, some past the reference's per-camera row cap.
    for name in ("carve", "unets", "select_head", "binning", "kernel", "resnet", "sh"):
        assert len(rec.spans[name]) == 2, name
    b = rec.values["binning"][0]
    assert b.counts.numel() == 8 * 28 * 2 and int(b.counts.sum()) > 0
    assert float(np.abs(got32).max()) > 0


def test_dry_run_writes_nothing(setup, tmp_path):
    """One frame at theta = 0, cast to float16, and no file written."""
    _, _, tm, data, weights = setup
    cfg = Config({"project_directory": str(tmp_path), "feature_fn": "f.npy"})
    out = tvf.calculate_visual_features(cfg, tm, data, resnet_weights=weights,
                                        L=L, dry_run=True, progress=False)
    assert out.shape == (1, (L + 1) ** 2, 512) and out.dtype == np.float16
    assert np.isfinite(out).all()
    assert list(tmp_path.iterdir()) == []
