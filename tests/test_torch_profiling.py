"""The port's profiling and log analysis (``utils/profiling.py``,
``utils/loganalysis.py``) against the JAX package's.

``profile_model`` returns the JAX function's keys with every time
positive, on a 3D model and an anchored 2D one (whose render
pose-transforms the anchors) at a small size (3 cameras at 32×32, grid
16); the JAX one runs once, in ``"global"`` mode with one iteration, for
its key set. ``trace`` writes a ``torch.profiler`` trace file. A training
log written by the port's ``train_from_config`` parses to the same dict,
summary and (with ``SOURCE_DATE_EPOCH`` set) the same PDF bytes in both
packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.utils import loganalysis as jla
from pose_splatter_tpu.utils import profiling as jprof
from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train.trainer import train_from_config
from pose_splatter_torch.utils import loganalysis as tla
from pose_splatter_torch.utils import profiling as tprof
from pose_splatter_torch.utils.synthetic import FrameSet, ring_cameras
from test_torch_model_3d import C, H, KW, W, _frames
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

TIMES = ("carve_ms", "unet_ms", "extract_ms", "render_fwd_ms", "full_fwd_ms",
         "full_fwd_bwd_ms", "render_mpix_s", "train_step_s",
         "train_steps_per_s")


@pytest.fixture(scope="module")
def scene():
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    frames = _frames(Ks, Es, 3)
    return Ks, Es, frames


def _inputs(frames, obs):
    return (frames["mask"][0, obs], frames["img"][0, obs], frames["p_3d"][0],
            float(frames["angle"][0]))


@pytest.fixture(scope="module")
def jax_keys(scene):
    Ks, Es, frames = scene
    jm = JModel(Ks, Es, W, H, render_mode="global", **KW)
    variables = random_variables(jm.net, jnp.zeros((1, 16, 16, 16, 4)),
                                 seed=0, train=False)
    report = jprof.profile_model(jm, variables,
                                 *_inputs(frames, jm.observed_views), iters=1)
    return list(report), report


@pytest.mark.parametrize("mode", ["3d", "2d_anchored"])
def test_profile_model_keys_match_jax(scene, jax_keys, mode):
    Ks, Es, frames = scene
    kw = dict(KW)
    if mode == "2d_anchored":
        kw.update(gaussian_mode="2d", gaussian_config={"view_anchored": True})
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **kw)
    report = tprof.profile_model(tm, *_inputs(frames, tm.observed_views),
                                 iters=2)
    keys, ref = jax_keys
    assert list(report) == keys
    for k in ("image", "grid", "max_gaussians"):
        assert report[k] == ref[k], k
    for k in TIMES:
        assert isinstance(report[k], float) and report[k] > 0, k
    assert report["train_steps_per_s"] == pytest.approx(
        1 / report["train_step_s"])


def test_time_fn_calls_and_times():
    calls = []
    s = tprof.time_fn(lambda x: calls.append(x), 3, iters=4, warmup=2)
    assert calls == [3] * 6 and s >= 0


def test_trace_writes_a_file(scene, tmp_path):
    Ks, Es, frames = scene
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    with tprof.trace(str(tmp_path / "trace")):
        tm(*_inputs(frames, tm.observed_views), 0)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 1000
    assert "aten::" in files[0].read_text()


@pytest.fixture(scope="module")
def training_logs(scene, tmp_path_factory):
    """The stdout of the port's train_from_config, 3 epochs of one step, in
    3D and in 2D, each written to a log file."""
    import contextlib
    import io

    Ks, Es, frames = scene
    obs = [0, 2]
    train = FrameSet({k: v[:2] for k, v in frames.items()}, obs)
    valid = FrameSet({k: v[2:] for k, v in frames.items()}, obs, split="valid")
    root = tmp_path_factory.mktemp("logs")
    logs = {}
    for mode in ("2d", "3d"):
        config = Config(dict(
            project_directory=str(root / mode), model_fn="checkpoint.pt",
            image_width=W, image_height=H, grid_size=KW["grid_size"],
            ell=KW["ell"], volume_idx=KW["volume_idx"], holdout_views=[1],
            volume_fill_color=0.38, gaussian_mode=mode, gaussian_config={},
            min_n=KW["min_n"], max_n=KW["max_n"], num_unets=2,
            base_filters=4, lr=1e-3, img_lambda=0.5, ssim_lambda=0.1,
            valid_every=2, plot_every=100, save_every=100))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_from_config(config, epochs=3, device="cpu", cameras=(Ks, Es),
                              datasets=(train, valid), max_batches=1)
        logs[mode] = root / f"{mode}.log"
        logs[mode].write_text("some warning\n" + out.getvalue())
    return logs


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_parse_training_log_matches_jax(training_logs, mode):
    got = tla.parse_training_log(str(training_logs[mode]))
    assert got == jla.parse_training_log(str(training_logs[mode]))
    assert got["epochs"] == [1, 2, 3] and len(got["validation"]) == 1
    assert all(np.isfinite(got["losses"]))


def test_convergence_summary_and_plot_match_jax(training_logs, tmp_path,
                                                monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    d2, d3 = (tla.parse_training_log(str(training_logs[m])) for m in ("2d", "3d"))
    got = tla.convergence_summary(d2, d3)
    assert got == jla.convergence_summary(d2, d3)
    assert set(got["3d"]) == {"final_loss", "loss_reduction_pct",
                              "epochs_to_within_10pct", "final_validation"}
    tla.plot_convergence_comparison(d2, d3, str(tmp_path / "t.pdf"))
    jla.plot_convergence_comparison(d2, d3, str(tmp_path / "j.pdf"))
    assert (tmp_path / "t.pdf").read_bytes() == (tmp_path / "j.pdf").read_bytes()
