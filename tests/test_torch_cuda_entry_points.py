"""The port's user entry points on the card, at small sizes.

``train_from_config`` and ``render_images_in_memory`` at the 2D and 3D
templates, at ``configs/baseline/pigeon_4.json`` (adaptive camera, 3D) and
at the 2D template in ``"tiled"`` mode, each cut to a small render and
grid, with the kernels' launches read a unit from ``stages.trace``: one
forward, one backward and one visibility launch a train step, one forward
and one visibility launch a frame (the validation's ``make_eval_step`` and
the renders), no compositor launch in tiled mode, a weight-gradient
launch for each conv the route sends to the kernel a train step, none a
frame, and one replay of the U-Net stack's CUDA graph a frame after its
warm-up frames, none a step; then both compositors
against their plain versions on a train step's own arrays; the same on a
step and a served frame of the 2D north star and of the 3D template at
their own sizes. The synthetic benchmark's entry point, and the temporal
benchmark's quality pass on the state it saved; the checkpoint round trip
through the JAX payload tree; ``graft_entry.entry`` against its CPU run; novel views, the
evaluation's metrics and LPIPS, and the Gaussian export against the CPU;
``profile_model`` and a trace; the visual-pose features with the
benchmark's rig against the CPU; a forward with the carve's visibility cap
against one without; and the stage-attribution probes with their
compositor launches and the checks they carry.

Every test is marked ``cuda`` and skips where no CUDA device is present.
On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda_entry_points.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax, which such a
machine need not have; this file imports only the port.)
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.models.pose_splatter import UNET_GRAPH_WARMUP
from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk
from pose_splatter_torch.utils import stages
from test_torch_cuda_kernels import (  # noqa: F401
    SMALL,
    TOL,
    _small_run,
    bwd_tol,
    deterministic_cudnn,
    hold_wgrad,
    record_wgrad,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _launches():
    return (tk.composite_instances.launches,
            tk.composite_instances_bwd.launches)


def hold_forward(inst, astarts, counts, origins, tile, G, mode):
    """The forward compositor against its plain version on binned arrays,
    ``tbounds`` stored: within TOL, ``jstop`` equal, finite."""
    args = (inst, astarts, counts, origins, tile, G, mode)
    got = tk.composite_instances(*args, save_tbounds=True)
    ref = tk.composite_instances_ref(*args, save_tbounds=True)
    for x, y in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, atol=TOL, rtol=0)
    assert torch.equal(got[2], ref[2])


def hold_kernels(rec):
    """Both compositors against their plain versions on the arrays that a
    recorded fwd+bwd binned and the ``tbounds`` and pixel gradients its
    backward got (``rec.values["kernel_bwd"]``). The forward as
    ``hold_forward``. The backward's columns each within ``bwd_tol`` of
    the column's largest entry; or, where a column's terms cancel
    (Gaussians stacked on one spot, as at a fresh start) and that bound
    does not hold, no farther from the plain version run in float64 than
    twice the float32 plain version's distance plus the bound."""
    bargs = rec.values["kernel_bwd"][-1]
    inst, _, astarts, counts, origins, jstop = bargs[:6]
    tile, G, mode = bargs[8:11]
    hold_forward(inst, astarts, counts, origins, tile, G, mode)
    d = tk.composite_instances_bwd(*bargs)
    d_ref = tk.composite_instances_bwd_ref(*bargs)
    assert torch.isfinite(d).all() and float(d.abs().max()) > 0
    tol = bwd_tol(tile, jstop, G)
    scale = d_ref.abs().amax(dim=0).clamp_min(1e-30)
    if float(((d - d_ref).abs().amax(dim=0) / scale).max()) <= tol:
        return
    d64 = tk.composite_instances_bwd_ref(*(
        x.double() if torch.is_tensor(x) and x.is_floating_point() else x
        for x in bargs))
    kernel_err = (d.double() - d64).abs().amax(dim=0)
    plain_err = (d_ref.double() - d64).abs().amax(dim=0)
    assert bool((kernel_err <= 2 * plain_err
                 + tol * d64.abs().amax(dim=0)).all())


def routed_convs(config) -> int:
    """The convs of the final U-Net at ``config``'s crop and width whose
    weight gradients the route sends to ``csrc/conv3d_wgrad.cu``: its
    launches a train step (the passthrough U-Nets' bodies run without a
    graph)."""
    from pose_splatter_torch.scripts.dbg_conv_wgrad_micro import unet_convs

    crop = [hi - lo for lo, hi in config.volume_idx]
    return sum(r["routed"]
               for r in unet_convs(crop, config.get("base_filters", 8)))


# ----------------------------------------------------------------------------
# train_from_config, make_eval_step and render_images_in_memory.
# ----------------------------------------------------------------------------

# Each preset's file, what is changed beside the small size, its cameras,
# the ring's focal length and the ellipsoid (offset from the crop's centre,
# semi-axes). The size: a render of 64x48 (96x48 for pigeon_4), a grid of
# 32 (16) and a crop whose sides divide by 16, as the U-Nets need.
CROP = [[0, 32], [8, 24], [8, 24]]
PRESETS = {
    "2d": ("configs/templates/tpu_2d.json",
           dict(image_width=128, image_height=96, grid_size=32,
                volume_idx=CROP), {"view_anchored": True}, 6, 150.0,
           (0.0, 0.0, 0.0), (0.055, 0.032, 0.028)),
    "3d": ("configs/templates/tpu_3d.json",
           dict(image_width=256, image_height=192, grid_size=32,
                volume_idx=CROP), {}, 6, 150.0,
           (0.0, 0.0, 0.0), (0.055, 0.032, 0.028)),
    "pigeon_4": ("configs/baseline/pigeon_4.json",
                 dict(image_width=192, image_height=96, grid_size=16,
                      volume_idx=[[0, 16]] * 3), {}, 4, 300.0,
                 (0.006, -0.004, 0.003), (0.025, 0.015, 0.013)),
    "2d_tiled": ("configs/templates/tpu_2d.json",
                 dict(image_width=128, image_height=96, grid_size=32,
                      volume_idx=CROP, render_mode="tiled"),
                 {"view_anchored": True}, 6, 150.0,
                 (0.0, 0.0, 0.0), (0.055, 0.032, 0.028)),
}
STEPS, VALID_FRAMES, RENDER_FRAMES = 3, 2, 2


def _scene(spec, n_frames, **over):
    """The ``Config`` of ``spec`` (a PRESETS or FULL entry) with the keys
    ``over``, its ring cameras and ``n_frames`` synthetic frames."""
    from pose_splatter_torch.config import Config
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    path, size, gaussian, C, focal, offset, axes = spec
    cfg = json.loads((ROOT / path).read_text())
    cfg.update(size)
    cfg.update(over)
    cfg["gaussian_config"] = dict(cfg["gaussian_config"], **gaussian)
    config = Config(cfg)
    W, H = config.render_width, config.render_height
    Ks, Es = ring_cameras(C, W, H, focal=focal, radius=0.6)
    grid = create_3d_grid(config.ell, config.grid_size, config.volume_idx)
    frames = synthetic_frames(Ks, Es, H, W,
                              grid.reshape(-1, 3).mean(0) + np.asarray(offset),
                              axes, n_frames=n_frames, seed=1)
    return config, Ks, Es, frames


def _preset(name, tmp_path, **over):
    """The preset's ``Config`` at its small size (``max_n`` 128, two
    U-Nets of width 4, validation every epoch, the project directory under
    ``tmp_path``) with the keys ``over``, its ring cameras and 6 synthetic
    frames."""
    return _scene(PRESETS[name], 6, **dict(
        dict(min_n=32, max_n=128, num_unets=2, base_filters=4, valid_every=1,
             project_directory=str(tmp_path)), **over))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_entry_points_launch_each_kernel_once_a_unit(dev, tmp_path, preset):
    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.train.evaluate import render_images_in_memory
    from pose_splatter_torch.train.loop import make_train_step
    from pose_splatter_torch.train.trainer import train_from_config
    from pose_splatter_torch.utils.synthetic import FrameSet

    config, Ks, Es, frames = _preset(preset, tmp_path)
    C = len(Ks)
    views = [v for v in range(C) if v not in config.holdout_views]
    train = FrameSet({k: v[:4] for k, v in frames.items()}, views, seed=2)
    valid = FrameSet({k: v[4:] for k, v in frames.items()}, views,
                     split="valid")
    with stages.trace(dev):
        state, losses, vlosses = train_from_config(
            config, epochs=1, max_batches=STEPS, batch_size=1, seed=0,
            device=dev, cameras=(Ks, Es), datasets=(train, valid),
            make_plots=False, progress=False)
        model = state.model
        rgba = render_images_in_memory(model, FrameSet(
            {k: v[:RENDER_FRAMES] for k, v in frames.items()}, views))
    units = stages.last_trace().units
    steps = [u for u in units if u["name"] == "step"]
    served = [u for u in units if u["name"] == "frame"]
    # The renders' host hook is a unit of its own; the loader's is not.
    hooks = [u for u in units if u["name"] == "adaptive"]
    assert state.step == len(steps) == STEPS
    assert len(served) == VALID_FRAMES + RENDER_FRAMES
    assert len(hooks) == (RENDER_FRAMES if config.adaptive_camera else 0)
    assert len(steps) + len(served) + len(hooks) == len(units)
    assert all(u["adaptive_calls"] == int(config.adaptive_camera)
               for u in steps + served)
    kernel = int(model.render_mode != "tiled")
    wgrad = routed_convs(config)
    assert wgrad == (0 if preset == "pigeon_4" else 4)
    for u in steps:
        assert u["launches"] == dict(composite_fwd=kernel,
                                     composite_bwd=kernel,
                                     carve_visibility=1,
                                     conv3d_wgrad=wgrad,
                                     unets_graph=0), u["launches"]
    # The served frames' U-Net stack: eager for its warm-up frames, then
    # one replay of its CUDA graph a frame (the capturing frame's too).
    for i, u in enumerate(served):
        assert u["launches"] == dict(
            composite_fwd=kernel, composite_bwd=0, carve_visibility=1,
            conv3d_wgrad=0, unets_graph=int(i >= UNET_GRAPH_WARMUP)
        ), (i, u["launches"])
    assert model.net.unet_graph_captures == 1
    assert model.net.unet_graph_replays == len(served) - UNET_GRAPH_WARMUP
    assert max(u["gaussians_live"] for u in steps) == config.max_n
    assert np.isfinite(losses).all() and np.isfinite(vlosses).all()
    for k, p in model.net.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), k
    assert rgba.shape == (RENDER_FRAMES, C, config.render_height,
                          config.render_width, 4)
    assert rgba[..., 3].max() > 0

    adaptive_fn = model.make_adaptive_fn() if config.adaptive_camera else None
    if adaptive_fn is not None:  # each frame's temp_K leaves K
        temp_K, _ = adaptive_fn(frames["mask"][0])
        assert float(np.abs(temp_K[:, :2, 2] - Ks[:, :2, 2]).max()) > 0
    if kernel:
        batch = next(iter(FrameLoader(train, batch_size=1, shuffle=False,
                                      prefetch=0, adaptive_fn=adaptive_fn)))
        step = make_train_step(model, state.optimizer, config.img_lambda,
                               config.ssim_lambda)
        with stages.record(dev) as rec:
            step(state, batch)
        hold_kernels(rec)


# The main path's own sizes: the 2D north star (tpu_2d.json view-anchored,
# 6 cameras at 576x512, grid 128, max_n 16,000, three U-Nets of width 8)
# and tpu_3d.json as written (288x256, grid 112), the ring's focal length
# scaled with the render's width.
FULL = {
    "2d_north_star": ("configs/templates/tpu_2d.json",
                      dict(min_n=1024, max_n=16000, num_unets=3,
                           base_filters=8), {"view_anchored": True}, 6,
                      800.0, (0.0, 0.0, 0.0), (0.055, 0.032, 0.028)),
    "3d": ("configs/templates/tpu_3d.json", {}, {}, 6, 400.0,
           (0.0, 0.0, 0.0), (0.055, 0.032, 0.028)),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_kernels_hold_on_a_full_size_step_and_frame(dev, tmp_path, name,
                                                     monkeypatch):
    """``train_from_config``'s fresh start and one step at the main path's
    size, then one more ``make_train_step`` step and one served frame
    (``render_images_in_memory``) recorded: both compositors against their
    plain versions on the step's own arrays (``hold_kernels``), the forward
    on each of the frame's binned arrays (``hold_forward``); the step's 12
    weight gradients from ``csrc/conv3d_wgrad.cu`` against float64 on the
    scene's own activations and output gradients (``hold_wgrad``)."""
    from pose_splatter_torch.data.dataset import FrameLoader
    from pose_splatter_torch.train.evaluate import render_images_in_memory
    from pose_splatter_torch.train.loop import make_train_step
    from pose_splatter_torch.train.trainer import train_from_config
    from pose_splatter_torch.utils.synthetic import FrameSet

    config, Ks, Es, frames = _scene(FULL[name], 3,
                                    project_directory=str(tmp_path))
    if name == "2d_north_star":
        assert (config.render_width, config.render_height,
                config.grid_size) == (576, 512, 128)
    else:
        assert (config.render_width, config.render_height,
                config.grid_size) == (288, 256, 112)
    views = [v for v in range(len(Ks)) if v not in config.holdout_views]
    train = FrameSet({k: v[:2] for k, v in frames.items()}, views, seed=2)
    valid = FrameSet({k: v[2:] for k, v in frames.items()}, views,
                     split="valid")
    state, losses, _ = train_from_config(
        config, epochs=1, max_batches=1, batch_size=1, seed=0, device=dev,
        cameras=(Ks, Es), datasets=(train, valid), make_plots=False,
        progress=False)
    assert np.isfinite(losses).all()
    model = state.model
    batch = next(iter(FrameLoader(train, batch_size=1, shuffle=False,
                                  prefetch=0)))
    step = make_train_step(model, state.optimizer, config.img_lambda,
                           config.ssim_lambda)
    calls = record_wgrad(monkeypatch)
    with stages.record(dev) as rec:
        step(state, batch)
    hold_kernels(rec)
    assert len(calls) == routed_convs(config) == 12
    for x, gy, out in calls:
        hold_wgrad(x, gy, out, before_bn=True)
    with stages.record(dev) as rec:
        render_images_in_memory(model, FrameSet(
            {k: v[2:] for k, v in frames.items()}, views))
    mode = "conic" if config.gaussian_mode == "3d" else "ellipse"
    assert rec.values["binning"]
    for b in rec.values["binning"]:
        hold_forward(b.inst, b.astarts, b.counts, b.origins,
                     model.tile_shape or tr.DEFAULT_TILE, tr.DEFAULT_CHUNK,
                     mode)


def test_capped_forward_matches_the_uncapped_one(dev):
    """An eval forward with the carve's visibility cap at the frame's
    occupied count against the forward without a cap: within 1e-4, one
    forward launch."""
    from pose_splatter_torch.ops.carving import carve_volume

    make, stack, _ = _small_run(dev, "2d")
    model = make()
    args = tuple(stack[k][0] for k in ("mask", "img", "p_3d", "angle"))
    vol = carve_volume(*(model._tensor(a) for a in args), model.grid, None,
                       model.Ks_obs, model.viewmats_obs,
                       volume_fill_color=model.volume_fill_color)
    view_idx = list(range(model.num_cameras))
    rgb0, alpha0 = model(*args, view_idx)
    model.carve_visibility_cap = int((vol[0] > 0).sum())
    before = _launches()
    rgb1, alpha1 = model(*args, view_idx)
    torch.cuda.synchronize()
    assert _launches()[0] - before[0] == 1
    assert float((rgb1 - rgb0).abs().max()) <= 1e-4
    assert float((alpha1 - alpha0).abs().max()) <= 1e-4


def test_synthetic_benchmark_on_the_card(dev, tmp_path):
    """``python -m pose_splatter_torch.scripts.synthetic_benchmark`` at a
    small size, 8 steps in calls of 4 (the captured step replayed) with the
    per-camera evaluation: the JAX script's report keys, the card's name as
    the backend, finite metrics, the compositors launched. The temporal
    benchmark on the state it saved: its quality pass's held-out PSNR
    within 1e-3 dB of the synthetic benchmark's evaluation."""
    from pose_splatter_torch.scripts import synthetic_benchmark as sb
    from pose_splatter_torch.scripts import temporal_benchmark as tb

    before = _launches()
    state = str(tmp_path / "state.pt")
    out = sb.main(["--cameras", "3", "--width", "32", "--height", "32",
                   "--grid", "16", "--frames", "2", "--min-n", "8",
                   "--max-n", "64", "--mode", "2d", "--anchored", "--steps",
                   "8", "--steps-per-call", "4", "--per-camera",
                   "--save-state", state])
    launched = [a - b for a, b in zip(_launches(), before)]
    assert set(out) == {
        "config", "steps", "train_time_s", "steps_per_s", "holdout_psnr_db",
        "holdout_ssim", "holdout_iou", "backend", "per_camera",
        "observed_psnr_db", "observed_ssim", "holdout_view", "hbm_peak_bytes",
        "hbm_limit_bytes"}
    assert out["backend"] == torch.cuda.get_device_name(0)
    nums = [out["holdout_psnr_db"], out["holdout_ssim"], out["holdout_iou"],
            out["observed_psnr_db"]] + [
        x for row in out["per_camera"].values() for x in row.values()]
    assert np.isfinite(nums).all() and len(out["per_camera"]) == 3
    assert min(launched) > 0
    rep = tb.main(["--state", state, "--length", "2"])
    assert abs(rep["holdout_psnr_db"] - out["holdout_psnr_db"]) <= 1e-3


# ----------------------------------------------------------------------------
# Checkpoints between the packages and the single-device entry.
# ----------------------------------------------------------------------------

def _leaves(tree):
    """The numpy leaves of a nested dict / tuple tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield np.asarray(tree)


def _payload_equal(x, y):
    opt = [(x["opt_state"]["state"][i][k], y["opt_state"]["state"][i][k])
           for i in x["opt_state"]["state"]
           for k in ("step", "exp_avg", "exp_avg_sq")]
    return (x["step"] == y["step"]
            and sorted(x["opt_state"]["state"]) == sorted(y["opt_state"]["state"])
            and all(torch.equal(a.cpu(), b.cpu()) for a, b in opt)
            and all(torch.equal(x[s][k], y[s][k])
                    for s in ("params", "batch_stats") for k in x[s]))


def test_checkpoint_round_trip_through_the_jax_tree(dev, tmp_path,
                                                    deterministic_cudnn):
    """A trained state (capturable Adam on the card) to the JAX payload
    tree and back, bit-equal, and the tree again equal; a twin resumed from
    the converted checkpoint file takes one step beside the original, the
    losses, weights and Adam state equal bit for bit."""
    from pose_splatter_torch.train import checkpoint_convert as cc
    from pose_splatter_torch.train.loop import (
        checkpoint_payload,
        create_train_state,
        load_checkpoint,
        make_train_step,
    )

    make, stack, idx = _small_run(dev, "2d")

    def batch(k):
        f = idx[0][k]
        b = {n: v[f:f + 1] for n, v in stack.items()}
        b.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
        return b

    state = create_train_state(make(), 1e-3)
    step = make_train_step(state.model, state.optimizer, 0.5, 0.1)
    for k in range(2):
        state, _ = step(state, batch(k))
    payload = checkpoint_payload(state)
    tree = cc.to_jax_tree(payload)
    assert _payload_equal(payload, cc.from_jax_tree(tree, state))
    again = cc.to_jax_tree(cc.from_jax_tree(tree, state))
    assert all(np.array_equal(x, y) for x, y in
               zip(_leaves(tree), _leaves(again)))

    twin = create_train_state(make(), 1e-3)
    with torch.no_grad():
        for p in twin.model.net.parameters():
            p.zero_()
    path = str(tmp_path / "converted.ckpt")
    cc.save_jax_tree(path, tree, twin, extra={"epoch": 1})
    twin, extra = load_checkpoint(path, twin)
    assert extra == {"epoch": 1}
    out = []
    for s in (state, twin):
        fn = make_train_step(s.model, s.optimizer, 0.5, 0.1)
        s, m = fn(s, batch(2))
        out.append((checkpoint_payload(s), float(m["total"])))
    (p0, l0), (p1, l1) = out
    assert l0 == l1 and _payload_equal(p0, p1)


def test_graft_entry_on_the_card_matches_the_cpu(dev):
    """``graft_entry.entry()`` on the card against its ``fn`` on the CPU
    with the same variables, within 1e-4."""
    from pose_splatter_torch import graft_entry

    fn, args = graft_entry.entry()
    rgb, alpha = fn(*args)
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    rgb_c, alpha_c = fn_cpu({k: v.cpu() for k, v in args[0].items()},
                            *args_cpu[1:])
    assert torch.isfinite(rgb).all() and float(alpha.max()) > 0
    assert float((rgb.cpu() - rgb_c).abs().max()) <= 1e-4
    assert float((alpha.cpu() - alpha_c).abs().max()) <= 1e-4


# ----------------------------------------------------------------------------
# Novel views, the evaluation and the export.
# ----------------------------------------------------------------------------

def _frame(stack):
    return tuple(stack[k][0] for k in ("mask", "img", "p_3d", "angle"))


def test_visual_features_with_the_configured_rig_on_the_card(dev, tmp_path):
    """``calculate_visual_features``, the preprocessing's entry point, with
    ``benchmark/configs/rtx3060_3d_features.json``'s ``visual_features``
    block (the 32-view rig of 224² at L = 3, its caps) on one frame of the
    small 3D model, on the card against the CPU: the float16 features
    within 1e-3 of the largest; on the card one forward compositor launch
    a frame and no instance row dropped."""
    from pose_splatter_torch.config import Config
    from pose_splatter_torch.preprocess.visual_features import (
        calculate_visual_features,
    )
    from pose_splatter_torch.utils.synthetic import FrameSet

    block = json.loads((ROOT / "benchmark/configs/rtx3060_3d_features.json")
                       .read_text())["visual_features"]
    outs = []
    for d in ("cpu", dev):
        make, stack, _ = _small_run(d, "3d")
        frames = {k: np.asarray(v[:1]) for k, v in stack.items()}
        data = FrameSet(frames, range(frames["mask"].shape[1]))
        config = Config({"project_directory": str(tmp_path), "feature_fn": "f.npy",
                         "visual_features": block})
        before = _launches()[0]
        with stages.trace(d):
            outs.append(calculate_visual_features(config, make(), data,
                                                  progress=False))
        unit = stages.last_trace().units[-1]
        assert unit["dropped_rows"] == 0 and unit["binned_rows"] > 0
    torch.cuda.synchronize()
    assert _launches()[0] - before == 1 == unit["launches"]["composite_fwd"]
    assert outs[0].shape == (1, 16, 512) and outs[0].dtype == np.float16
    ref = outs[0].astype(np.float32)
    err = float(np.abs(outs[1].astype(np.float32) - ref).max())
    assert err <= 1e-3 * float(np.abs(ref).max()), err


def test_novel_views_on_the_card(dev):
    """``render_turntable`` at twice the render size through the ring's
    intrinsics scaled alike: one forward launch a view, every view finite
    and showing the animal; the forward kernel against its plain version
    on a view's own binned arrays, ``tbounds`` included."""
    from pose_splatter_torch.utils.synthetic import ring_cameras
    from pose_splatter_torch.viz.render_image import (
        render_novel_view,
        render_turntable,
    )

    (C, H, W), focal, _, _ = SMALL["3d"]
    make, stack, _ = _small_run(dev, "3d")
    model = make()
    K_full = ring_cameras(C, W, H, focal=focal, radius=0.6)[0]
    K_full[:, :2] *= 2
    inputs = _frame(stack)
    before = _launches()[0]
    views = render_turntable(model, *inputs, 0, K_full, 2 * W, 2 * H,
                             n_steps=4)
    assert _launches()[0] - before == 4
    assert views.shape == (4, 2 * H, 2 * W, 3) and np.isfinite(views).all()
    assert ((views.min(-1) < 0.9).sum(axis=(1, 2)) > 0).all()
    with stages.record(dev) as rec:
        render_novel_view(model, *inputs, 0, K_full, 2 * W, 2 * H)
    b = rec.values["binning"][0]
    hold_forward(b.inst, b.astarts, b.counts, b.origins, tr.DEFAULT_TILE,
                 tr.DEFAULT_CHUNK, "conic")


def test_evaluation_metrics_on_the_card_match_the_cpu(dev, tmp_path):
    """``image_metrics`` and ``lpips_metric`` (seeded AlexNet weights) over
    the test split of ``render_images_in_memory``'s renders at the 3D
    preset's own render size, 288x256, against its frames, the same uint8
    arrays on the card and on the CPU: each per-camera value within 1e-5
    relative. (SSIM's float32 variances cancel in flat regions and its
    mean is over fewer pixels at a smaller size, where the gap grows.)"""
    from pose_splatter_torch.ops.lpips import create_lpips
    from pose_splatter_torch.train.evaluate import (
        image_metrics,
        lpips_metric,
        render_images_in_memory,
    )
    from pose_splatter_torch.train.trainer import build_model
    from pose_splatter_torch.utils.synthetic import FrameSet
    from test_torch_cuda_kernels import _lpips_npz

    config, Ks, Es, frames = _preset("3d", tmp_path, image_width=1152,
                                     image_height=1024)
    assert (config.render_width, config.render_height) == (288, 256)
    model = build_model(config, cameras=(Ks, Es), device=dev, seed=0)
    views = [v for v in range(len(Ks)) if v not in config.holdout_views]
    pred = render_images_in_memory(model, FrameSet(frames, views))
    gt = np.round(frames["img"] * 255).astype(np.uint8)
    path = _lpips_npz(tmp_path / "lpips.npz")
    runs = []
    for d in ("cpu", dev):
        m = image_metrics(pred, gt, split="test", device=d)
        m["lpips"] = lpips_metric(pred, gt, create_lpips(path, d),
                                  split="test", device=d)
        runs.append(m)
    assert sorted(runs[0]) == sorted(runs[1])
    for k, ref in runs[0].items():
        rel = np.abs(runs[1][k] - ref) / np.maximum(np.abs(ref), 1e-30)
        assert rel.shape == (len(Ks),) and float(rel.max()) <= 1e-5, (k, rel)


def test_export_on_the_card_matches_the_cpu(dev, tmp_path):
    """``extract_world_gaussians`` on the card against a CPU twin of the
    model: the same Gaussians (rows matched by the voxel the selection
    picked), each parameter within 1e-5 of its array's largest; the four
    savers write their files and the npz reads back."""
    from pose_splatter_torch.viz.export import (
        EXTENSIONS,
        SAVERS,
        extract_world_gaussians,
    )

    make, stack, _ = _small_run(dev, "3d")
    card = make()
    cpu = _small_run(torch.device("cpu"), "3d")[0]()
    cpu.net.load_state_dict(card.net.state_dict())
    inputs = _frame(stack)
    got, selected = {}, {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        got[name] = extract_world_gaussians(model, *inputs)
        with torch.no_grad():
            g, indices = model.frame_gaussians(*inputs)
        model.check_selection()
        selected[name] = indices[g["valid"]].cpu().numpy()
    common, ic, ip = np.intersect1d(selected["cuda"], selected["cpu"],
                                    return_indices=True)
    assert len(got["cuda"]["means"]) == len(got["cpu"]["means"]) == len(common) > 0
    for k in ("means", "quaternions", "scales", "opacities", "colors"):
        a, c = got["cuda"][k][ic], got["cpu"][k][ip]
        assert float(np.abs(a - c).max()) <= 1e-5 * float(np.abs(c).max()), k
    assert float(np.abs(got["cuda"]["center"] - got["cpu"]["center"]).max()) \
        <= 1e-5 * float(np.abs(got["cpu"]["center"]).max())
    for fmt, saver in SAVERS.items():
        fn = tmp_path / f"gaussians_{fmt}.{EXTENSIONS[fmt]}"
        saver(got["cuda"], str(fn))
        assert fn.stat().st_size > 0, fmt
    back = np.load(tmp_path / "gaussians_npz.npz", allow_pickle=True)
    for k in ("means", "quaternions", "scales", "opacities", "colors", "center"):
        assert np.array_equal(back[k], got["cuda"][k]), k


def test_profile_model_and_trace_on_the_card(dev, tmp_path):
    """``profile_model`` launches the forward compositor in its render, its
    forward and its forward-and-backward, the backward in the last, once a
    call of each (``time_fn``'s two warm-up calls and ``iters`` timed
    ones); ``trace`` over one ``fwd_bwd`` writes a non-empty trace."""
    from pose_splatter_torch.utils.profiling import fwd_bwd, profile_model, trace

    make, stack, _ = _small_run(dev, "2d")
    model = make()
    inputs = _frame(stack)
    iters = 1
    before = _launches()
    prof = profile_model(model, *inputs, iters=iters)
    torch.cuda.synchronize()
    calls = iters + 2
    assert [a - b for a, b in zip(_launches(), before)] == [3 * calls, calls]
    assert prof["full_fwd_bwd_ms"] > 0
    with trace(str(tmp_path / "trace")):
        fwd_bwd(model, *inputs)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


# ----------------------------------------------------------------------------
# The stage-attribution probes.
# ----------------------------------------------------------------------------

RAST = ["--height", "32", "--width", "48", "--n", "200"]
MODEL = ["--width", "48", "--height", "32", "--grid", "32", "--crop",
         "0,16,0,16,8,24", "--min-n", "16", "--max-n", "128"]
# Each probe at a small size with one timed call a line, and its compositor
# launches (forward, backward): a line that launches does so on its warm-up
# call and its timed one.
PROBES = {
    "dbg_dispatch_floor": ([], (0, 0)),
    "bench_breakdown": (RAST, (2 * 5, 2 * 2)),
    "dbg_rast_breakdown": (RAST, (2 * 4, 2 * 2)),
    "dbg_kernel_profile": (["64", "8", "128", "full"] + RAST, (2 * 8, 2 * 5)),
    "dbg_gather_bwd": (["--n", "300", "--mcap", "2048"], (0, 0)),
    "dbg_bin_micro": (["--n", "400", "--tiles", "20", "--mcap", "2048"],
                      (0, 0)),
    "dbg_carve_micro": (["--voxels", "6000", "--height", "24", "--width",
                         "32"], (0, 0)),
    "dbg_model_breakdown": (MODEL, (2 * 4, 2 * 3)),
    "dbg_step_bisect": (["all"] + MODEL, (2 * 4, 2 * 4)),
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_on_the_card(dev, name):
    """Each probe's ``main`` on the card: its compositor launches, every
    line a positive time, and the checks it carries (``dbg_gather_bwd``'s
    two backward forms ``allclose``, the carve micro's visibility variants
    equal)."""
    argv, expect = PROBES[name]
    mod = importlib.import_module(f"pose_splatter_torch.scripts.{name}")
    before = _launches()
    out = mod.main(argv + ["--iters", "1"])
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == expect
    assert out["lines"] and all(v > 0 for v in out["lines"].values())
    assert out["card"] != "cpu"
    if name == "dbg_gather_bwd":
        assert out["allclose"]
    if name == "dbg_carve_micro":
        assert all(out["agree"].values())


def test_vmap_probe_parity_with_the_row_cap_lifted(dev):
    """``dbg_vmap_kernel`` at its own shape: the batched kernel renders and
    gradients against per-frame ``"global"`` renders (it raises on a
    mismatch), nothing dropped at the lifted cap; 3 frames at the default
    cap, at the lifted one, then with gradients."""
    from pose_splatter_torch.scripts import dbg_vmap_kernel

    before = _launches()
    out = dbg_vmap_kernel.main([])
    assert out["parity"] and out["dropped_default_cap"] > 0
    assert tuple(a - b for a, b in zip(_launches(), before)) == (9, 3)


def test_bench_breakdown_recorded_arrays_hold_the_kernels(dev):
    """The fwd+bwd that ``bench_breakdown.run(record=True)`` records: both
    compositors against their plain versions on its arrays."""
    from pose_splatter_torch.scripts import bench_breakdown

    out = bench_breakdown.run(iters=1, H=64, W=96, N=800, record=True)
    hold_kernels(out["recording"])
