"""The port's plots (``viz/plots.py``), the trainer's plots and the
optional Rerun viewer (``viz/rerun_viz.py``) against the JAX package's.

With ``SOURCE_DATE_EPOCH`` set, matplotlib writes the same PDF bytes for
the same figure, so each plot that draws data (not a model's render) must
be byte-identical to the JAX package's on the same inputs.
``splat_volume_preview`` renders in ``"tiled"`` mode in both packages:
its image within 1e-4 of the JAX rasterizer's on the same Gaussians, its
8-bit PNG within one level of JAX's. ``plot_predictions`` runs a port
model; it imports matplotlib before any forward, so a machine without
matplotlib runs no forward for it. Rerun is not installed here, so its
viewer test skips; the guard's message is checked.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.ops.rasterize import rasterize as jrasterize
from pose_splatter_tpu.viz import plots as jp
from pose_splatter_tpu.viz import rerun_viz as jrr
from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train.trainer import train_from_config
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import FrameSet, ring_cameras
from pose_splatter_torch.viz import plots as tp
from pose_splatter_torch.viz import rerun_viz as trr
from test_torch_model_3d import C, H, KW, W, _frames

pytest.importorskip("matplotlib")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fixed_pdf_date(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    T = 24
    a = rng.normal(size=(T, 3, 3))
    return dict(
        g={"means": rng.normal(0, 0.02, (200, 3)),
           "colors": rng.uniform(-0.1, 1.1, (200, 3))},
        means=np.cumsum(rng.normal(0, 0.004, (T, 3)), 0),
        covs=a @ a.transpose(0, 2, 1) * 1e-4 + np.eye(3) * 1e-5,
        losses=[[0.5 / e, 0.2 / e, 0.1 / e ** 0.5] for e in range(1, 7)],
        volume=rng.uniform(size=(7, 6, 5)))


PLOTS = {
    "gaussian_scatter": lambda m, d, fn: m.plot_gaussian_scatter(d["g"], fn),
    "ellipses": lambda m, d, fn: m.plot_ellipses(d["means"], d["covs"], fn),
    "losses": lambda m, d, fn: m.plot_losses(d["losses"], [0.9, 0.6, 0.5], 2,
                                             fn),
    "voxels": lambda m, d, fn: m.plot_voxels(d["volume"], fn),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_byte_identical_to_jax(tmp_path, name):
    d = _data()
    jfn, tfn = str(tmp_path / "j.pdf"), str(tmp_path / "t.pdf")
    assert PLOTS[name](jp, d, jfn) == jfn
    assert PLOTS[name](tp, d, tfn) == tfn
    data = open(tfn, "rb").read()
    assert data.startswith(b"%PDF") and len(data) > 2000
    assert data == open(jfn, "rb").read()


@pytest.fixture(scope="module")
def preview_inputs():
    """A carved-looking volume on a 16³ grid and one ring camera."""
    rng = np.random.default_rng(4)
    grid = create_3d_grid(0.3, 16)
    r = np.linalg.norm(grid, axis=-1)
    occ = (r < 0.09).astype(np.float32) * rng.uniform(0.4, 1.0, r.shape)
    volume = np.concatenate([occ[None], rng.uniform(0, 1, (3,) + r.shape)],
                            0).astype(np.float32)
    Ks, Es = ring_cameras(2, 48, 40, focal=90.0, radius=0.6)
    return volume, grid, Ks[1], Es[1]


def test_volume_preview_image_matches_jax_rasterizer(preview_inputs):
    """The Gaussians ``plots.py:140-173`` builds, through the JAX
    rasterizer in ``"tiled"`` mode."""
    volume, grid, K, E = preview_inputs
    got = tp.volume_preview_image(volume, grid, K, E, 48, 40, log_scale=-5.0,
                                  device="cpu")
    n = grid[..., 0].size
    ref, _ = jrasterize(
        jnp.asarray(grid.reshape(-1, 3)), jnp.tile(jnp.array([1.0, 0, 0, 0]),
                                                   (n, 1)),
        jnp.full((n, 3), float(np.exp(-5.0))), jnp.full((n,), 0.95),
        jnp.asarray(volume[1:4].reshape(3, -1).T), jnp.asarray(E)[None],
        jnp.asarray(K)[None], 48, 40,
        valid=jnp.asarray(volume[0].reshape(-1) > 0.5),
        backgrounds=jnp.ones(3), mode="tiled")
    assert got.shape == (40, 48, 3)
    np.testing.assert_allclose(got, np.clip(np.asarray(ref[0]), 0, 1),
                               atol=1e-4)
    assert got.min() < 0.5  # the occupied voxels show


def test_splat_volume_preview_matches_jax(preview_inputs, tmp_path):
    import matplotlib.pyplot as plt

    volume, grid, K, E = preview_inputs
    jfn = jp.splat_volume_preview(volume, grid, K, E, 48, 40, log_scale=-5.0,
                                  save_path=str(tmp_path / "j.png"))
    tfn = tp.splat_volume_preview(volume, grid, K, E, 48, 40, log_scale=-5.0,
                                  save_path=str(tmp_path / "t.png"),
                                  device="cpu")
    j, t = plt.imread(jfn), plt.imread(tfn)
    assert t.shape == j.shape == (40, 48, 4)
    np.testing.assert_allclose(t, j, atol=1.01 / 255)
    assert (t == j).mean() > 0.99


@pytest.fixture(scope="module")
def model_and_data():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    with torch.no_grad():
        tm.net.scale.fill_(float(np.log(0.03)))
    frames = _frames(Ks, Es, 3)
    return tm, FrameSet(frames, tm.observed_views), (Ks, Es), frames


def test_plot_predictions_on_a_port_model(model_and_data, tmp_path):
    tm, data, _, _ = model_and_data
    out = tp.plot_predictions(tm, data, save_path=str(tmp_path / "r.pdf"),
                              num_examples=2)
    assert open(out, "rb").read(4) == b"%PDF"


def test_plot_predictions_imports_matplotlib_first(model_and_data,
                                                   monkeypatch, tmp_path):
    """Without matplotlib it raises ImportError before any forward."""
    tm, data, _, _ = model_and_data
    calls = []
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(type(tm), "forward",
                        lambda *a, **k: calls.append(1))
    with pytest.raises(ImportError):
        tp.plot_predictions(tm, data, save_path=str(tmp_path / "r.pdf"))
    assert calls == []


@pytest.mark.parametrize("make_plots", [True, False])
def test_train_from_config_plots(model_and_data, tmp_path, capsys,
                                 make_plots):
    """``plot_every`` 1: reconstruction.pdf and loss.pdf in the project
    directory each epoch (none with ``make_plots`` False); ``progress``
    False prints no epoch line."""
    _, _, cams, frames = model_and_data
    obs = [0, 2]
    train = FrameSet({k: v[:2] for k, v in frames.items()}, obs)
    valid = FrameSet({k: v[2:] for k, v in frames.items()}, obs, split="valid")
    config = Config(dict(
        project_directory=str(tmp_path), model_fn="checkpoint.pt",
        image_width=W, image_height=H, grid_size=KW["grid_size"],
        ell=KW["ell"], volume_idx=KW["volume_idx"], holdout_views=[1],
        volume_fill_color=0.38, gaussian_mode="3d", gaussian_config={},
        min_n=KW["min_n"], max_n=KW["max_n"], num_unets=2, base_filters=4,
        lr=1e-3, img_lambda=0.5, ssim_lambda=0.0, valid_every=1,
        plot_every=1, save_every=5))
    _, losses, _ = train_from_config(
        config, epochs=1, device="cpu", cameras=cams, datasets=(train, valid),
        max_batches=1, make_plots=make_plots, progress=False)
    assert len(losses) == 1
    plots = {"reconstruction.pdf", "loss.pdf"}
    written = {p.name for p in tmp_path.iterdir()} & plots
    assert written == (plots if make_plots else set())
    out = capsys.readouterr().out
    assert "epoch 1:" not in out and "validation:" not in out


def test_rerun_guard_message():
    if _has_rerun():
        pytest.skip("rerun is installed; test_rerun_viewer covers it")
    with pytest.raises(ImportError) as t_err:
        trr.log_gaussians({"scales": np.ones((1, 3)), "colors": np.ones((1, 3)),
                           "means": np.zeros((1, 3))})
    with pytest.raises(ImportError) as j_err:
        jrr.log_gaussians({"scales": np.ones((1, 3)), "colors": np.ones((1, 3)),
                           "means": np.zeros((1, 3))})
    assert str(t_err.value) == str(j_err.value)


def _has_rerun():
    try:
        import rerun  # noqa: F401
    except ImportError:
        return False
    return True


def test_rerun_viewer(tmp_path):
    pytest.importorskip("rerun")
    g = _data()["g"]
    np.savez(tmp_path / "g.npz", means=g["means"], colors=g["colors"],
             scales=np.full((len(g["means"]), 3), 0.002))
    trr.view_gaussian_npz(str(tmp_path / "g.npz"),
                          save_rrd=str(tmp_path / "g.rrd"), spawn=False)
    assert (tmp_path / "g.rrd").stat().st_size > 0
