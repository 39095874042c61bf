"""The port's user CLIs (``python -m pose_splatter_torch.scripts.<name>``,
called in process with ``--device cpu``) on a synthetic project, each
output held against the JAX package's functions on the same weights.

The project is ``tests/test_end_to_end.py::synth_project``'s (3D, 3
cameras at 48², 9 frames of a coloured ball, grid 16, up to 256
Gaussians), built here with the port's camera helpers. The train CLI
trains 2 epochs; its checkpoint crosses to the JAX package through
``train/checkpoint_convert.py::load_jax_tree``, and the JAX references
run in ``"global"`` mode (the port's CLIs in the config's default
``"kernel"`` mode: the compositor's plain version on the CPU).

Tolerances: the validation loss rtol 1e-4; rendered uint8 images within
one level of the JAX float render's uint8 (the images agree within 1e-4
before the cast); Gaussian parameters within 1e-5 of each array's
largest, counts exact; saved PLY / JSON byte-identical to the JAX savers'
output on the CLI's own Gaussians; metrics as in
``test_torch_evaluate.py``. ``test_torch_cli_tools.py`` covers
``visualize``, ``profile`` and ``analyze_convergence``.
"""

import collections
import contextlib
import importlib
import io
import json
import os
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pose_splatter_torch.scripts as scripts_pkg
from pose_splatter_torch.train.checkpoint_convert import load_jax_tree
from test_torch_evaluate import lpips_weights  # noqa: F401  (a fixture)

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)

C, IMG, T = 3, 48, 9
# Every user CLI of the port and its subcommands (None: no subcommand).
CLIS = {
    "train": None,
    "evaluate": None,
    "render_image": None,
    "export_gaussians": None,
    "generate_videos": ("360", "multiview", "temporal"),
    "visualize": ("gaussians", "voxels", "training", "renders", "ellipses"),
    "profile": ("synthetic", "config"),
    "analyze_convergence": None,
    # The utility scripts (tested in test_torch_cli_utils.py).
    "doctor": None,
    "dataset_utils": ("verify", "compare", "update_paths", "analyze"),
    "organize_export": None,
    "estimate_up_direction": None,
}
# CLIs that run on the host only: their --device is accepted and ignored.
HOST_ONLY = {"analyze_convergence", "dataset_utils", "organize_export",
             "estimate_up_direction"}
# Modules of pose_splatter_torch/scripts that are not user CLIs of the
# JAX package's Quick start (tested in their own files).
OTHER = {"bench", "dbg_dyngather_micro", "preprocess", "synthetic_benchmark",
         "common", "temporal_benchmark", "dbg_input_pipeline", "scaling",
         "dbg_highres_sharded"}
U8 = 1.0 / 255


def make_project(root, gaussian_mode="3d"):
    """The synthetic project of ``test_end_to_end.py::synth_project``:
    config.json path."""
    from pose_splatter_torch.utils.cameras import (
        camera_extrinsic_spherical,
        get_cam_params,
    )

    proj = root / "project"
    for d in (proj, proj / "images", proj / "renders"):
        os.makedirs(d, exist_ok=True)
    f = 60.0
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]])
    Ks = np.stack([K] * C)
    Es = np.stack([camera_extrinsic_spherical(1.0, np.pi / 2.5,
                                              2 * np.pi * i / C)
                   for i in range(C)])
    cam_fn = str(proj / "camera_params.h5")
    with h5py.File(cam_fn, "w") as hf:
        grp = hf.create_group("camera_parameters")
        grp.create_dataset("intrinsic", data=Ks)
        grp.create_dataset("rotation", data=Es[:, :3, :3])
        grp.create_dataset("translation", data=Es[:, :3, 3])
    up_fn = str(proj / "vertical_lines.npz")
    np.savez(up_fn, up=np.array([0.0, 0.0, -1.0]))
    intr, extr, _ = get_cam_params(cam_fn, ds=1, up_fn=up_fn, auto_orient=True)

    rng = np.random.default_rng(0)
    centers = 0.05 * rng.normal(size=(T, 3)).astype(np.float64)
    angles = np.linspace(0, 0.5, T)
    ball_r = 0.08
    images = np.full((T, C, IMG, IMG, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    for t in range(T):
        for c in range(C):
            cam = extr[c] @ np.append(centers[t], 1.0)
            pix = intr[c] @ cam[:3]
            u, v = pix[0] / pix[2], pix[1] / pix[2]
            rad = intr[c][0, 0] * ball_r / cam[2]
            m = ((xx - u) ** 2 + (yy - v) ** 2) < rad ** 2
            images[t, c][m] = np.array([180, 60, 120], np.uint8)
    with h5py.File(str(proj / "images" / "images.h5"), "w") as hf:
        hf.create_dataset("images", data=images, compression="gzip",
                          compression_opts=2)
    np.savez(str(proj / "center_rotation.npz"),
             centers=centers.astype(np.float32), angles=angles,
             covs=np.tile(np.eye(3)[None] * ball_r ** 2, (T, 1, 1)))
    config = {
        "data_directory": str(root), "project_directory": str(proj),
        "holdout_views": [], "image_directory": "images",
        "render_directory": "renders", "image_compression_level": 2,
        "camera_fn": "camera_params.h5",
        "vertical_lines_fn": "vertical_lines.npz",
        "center_rotation_fn": "center_rotation.npz",
        "volume_sum_fn": "volume_sum.npy", "model_fn": "checkpoint.pt",
        "feature_fn": "features.npy", "embedding_fn": "embedding.npy",
        "image_width": IMG, "image_height": IMG, "image_downsample": 1,
        "adaptive_camera": False, "ell": 0.4, "ell_tracking": 0.4,
        "grid_size": 16, "frame_jump": 1,
        "volume_idx": [[0, 16], [0, 16], [0, 16]], "volume_fill_color": 0.45,
        "img_lambda": 0.5, "ssim_lambda": 0.0, "lr": 1e-3, "valid_every": 1,
        "plot_every": 100, "save_every": 1, "gaussian_mode": gaussian_mode,
        "gaussian_config": {}, "min_n": 16, "max_n": 256, "num_unets": 2,
        "base_filters": 4,
    }
    cfg_fn = str(proj / "config.json")
    with open(cfg_fn, "w") as fcfg:
        json.dump(config, fcfg)
    return cfg_fn


def run_cli(name, *args):
    """Run ``pose_splatter_torch.scripts.<name>`` in process on the CPU;
    returns (its return value, its stdout)."""
    mod = importlib.import_module(f"pose_splatter_torch.scripts.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = mod.main([*args, "--device", "cpu"])
    return ret, out.getvalue()


def train_project(root, gaussian_mode="3d"):
    """A project trained 2 epochs by the train CLI: (config path, log)."""
    cfg = make_project(root, gaussian_mode)
    _, log = run_cli("train", cfg, "--epochs", "2")
    return cfg, log


def jax_model(cfg):
    """The JAX package's model of ``cfg`` in ``"global"`` mode with the
    port's checkpoint as Flax variables."""
    from pose_splatter_tpu.config import Config as JConfig
    from pose_splatter_tpu.train.trainer import build_model, checkpoint_path

    config = JConfig(cfg)
    tree, _ = load_jax_tree(checkpoint_path(config, False))
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return config, build_model(config, render_mode="global"), variables


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg, log = train_project(tmp_path_factory.mktemp("cli"))
    config, jm, variables = jax_model(cfg)
    return dict(cfg=cfg, log=log, config=config, jm=jm, variables=variables)


def _jax_frame(config, frame, view=0):
    from pose_splatter_tpu.train.trainer import build_datasets

    (dset,) = build_datasets(config, splits=("all_volumes",))
    return dset.get(frame, view_idx=view)[:4]


def _png(fn):
    from PIL import Image

    return np.asarray(Image.open(fn).convert("RGB"))


def _close_u8(got_u8, ref_float):
    """uint8 image against a float one in [0, 1] cast as the CLIs cast."""
    ref_u8 = (np.asarray(ref_float) * 255).astype(np.uint8)
    assert got_u8.shape == ref_u8.shape
    assert np.abs(got_u8.astype(int) - ref_u8).max() <= 1


def test_every_cli_is_tested():
    """Every module of pose_splatter_torch/scripts is a CLI tested here,
    in test_torch_cli_tools.py or in test_torch_cli_utils.py, or a listed
    other; each CLI, and each of
    its subcommands, takes --device, and those that run on the host only
    say in its help that they ignore it."""
    names = {m.name for m in pkgutil.iter_modules(scripts_pkg.__path__)}
    assert names == set(CLIS) | OTHER
    for name, subs in CLIS.items():
        parser = importlib.import_module(
            f"pose_splatter_torch.scripts.{name}").build_parser()
        if parser._subparsers is not None:
            choices = parser._subparsers._group_actions[0].choices
            assert set(choices) == set(subs), name
            parsers = list(choices.values())
        else:  # generate_videos takes its mode as a positional argument
            modes = [a.choices for a in parser._actions if a.dest == "mode"]
            assert modes == ([list(subs)] if subs else []), name
            parsers = [parser]
        for p in parsers:
            (device,) = [a for a in p._actions if "--device" in a.option_strings]
            host_only = name in HOST_ONLY or (
                name == "visualize" and p.prog.split()[-1] != "voxels")
            assert device.help.startswith("ignored") == host_only, p.prog


def test_train(trained):
    """Two epochs logged and saved; the last validation loss equals the
    JAX eval step's on the checkpoint's weights over the valid split, its
    views drawn as the trainer's second validation pass drew them (a
    fresh loader's second pass: each frame's view comes from the
    dataset's seeded generator)."""
    from pose_splatter_tpu.data.dataset import FrameLoader
    from pose_splatter_tpu.train.loop import make_eval_step
    from pose_splatter_tpu.train.trainer import build_datasets, checkpoint_path
    from pose_splatter_torch.utils.loganalysis import parse_training_log

    config, jm, variables = trained["config"], trained["jm"], trained["variables"]
    with open(checkpoint_path(config, False) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 2 and len(meta["losses"]) == 2
    log = os.path.join(config.project_directory, "train.log")
    with open(log, "w") as f:
        f.write(trained["log"])
    parsed = parse_training_log(log)
    assert parsed["epochs"] == [1, 2] and len(parsed["validation"]) == 2
    (valid_ds,) = build_datasets(config, splits=("valid",))
    eval_fn = make_eval_step(jm, config.img_lambda, config.ssim_lambda)
    S = collections.namedtuple("S", "params batch_stats")
    state = S(variables["params"], variables["batch_stats"])
    loader = FrameLoader(valid_ds, batch_size=1, shuffle=False)
    list(loader)  # the first validation pass
    losses = [float(eval_fn(state, {k: jnp.asarray(v) for k, v in b.items()})[0])
              for b in loader]
    assert len(losses) == 3
    np.testing.assert_allclose(meta["validation_losses"][-1], np.mean(losses),
                               rtol=1e-4)


def test_evaluate(trained, lpips_weights):
    """rendered_images.h5 against the JAX render_images on the same
    weights; metrics_test.csv and the summary's LPIPS against the JAX
    metrics on the CLI's own renders."""
    from pose_splatter_tpu.train import evaluate as jev
    from pose_splatter_tpu.train.trainer import build_datasets

    config, jm, variables = trained["config"], trained["jm"], trained["variables"]
    metrics, _ = run_cli("evaluate", trained["cfg"], "--lpips_weights",
                         lpips_weights)
    render_fn = os.path.join(config.render_directory, "rendered_images.h5")
    gt_fn = os.path.join(config.image_directory, "images.h5")
    (test_ds,) = build_datasets(config, splits=("test",))
    jfn = os.path.join(config.render_directory, "jax_rendered.h5")
    jev.render_images(jm, variables, test_ds, T, jfn, progress=False)
    with h5py.File(render_fn) as t, h5py.File(jfn) as j:
        got, ref = t["images"][:], j["images"][:]
    assert got.shape == (T, C, IMG, IMG, 4) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref).max() <= 1
    assert not got[:6].any() and got[6:, ..., 3].max() > 128

    jcsv = os.path.join(config.project_directory, "jax_metrics.csv")
    ref = jev.calculate_image_metrics(render_fn, gt_fn, jcsv, progress=False)
    tcsv = os.path.join(config.project_directory, "metrics_test.csv")
    assert open(tcsv).readline() == open(jcsv).readline()
    tvals, jvals = np.loadtxt(tcsv, delimiter=","), np.loadtxt(jcsv, delimiter=",")
    for i, k in enumerate(sorted(ref)):
        rtol, atol = (0, 1e-4) if k == "ssim" else (1e-5, 0)
        np.testing.assert_allclose(metrics[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)
        np.testing.assert_allclose(tvals[:, i], jvals[:, i], rtol=rtol,
                                   atol=atol + 1.01e-6, err_msg=k)
    ref_lpips = jev.calculate_lpips_metric(render_fn, gt_fn, lpips_weights)
    with open(os.path.join(config.project_directory,
                           "evaluation_metrics.json")) as f:
        summary = json.load(f)
    assert set(summary) == set(ref) | {"lpips"}
    np.testing.assert_allclose(summary["lpips"]["per_camera"],
                               np.asarray(ref_lpips), rtol=1e-5)


def test_render_image(trained, tmp_path):
    from pose_splatter_tpu.viz.render_image import render_novel_view
    from pose_splatter_torch.scripts.common import full_res_intrinsics

    config, jm, variables = trained["config"], trained["jm"], trained["variables"]
    out = str(tmp_path / "novel.png")
    run_cli("render_image", trained["cfg"], "--frame", "4", "--view", "1",
            "--angle_offset", "0.5", "--dx", "0.01", "--dz", "-0.01",
            "--output", out)
    ref = render_novel_view(jm, variables, *_jax_frame(config, 4, 1), 1,
                            full_res_intrinsics(config), IMG, IMG,
                            angle_offset=0.5, delta_xyz=(0.01, 0.0, -0.01))
    got = _png(out)
    _close_u8(got, ref)
    assert (got.min(-1) < 200).sum() > 20  # the ball is in view
    # The default name is the JAX script's.
    run_cli("render_image", trained["cfg"], "--frame", "2")
    assert os.path.exists(os.path.join(config.project_directory,
                                       "render_f0002_v0.png"))


@pytest.fixture(scope="module")
def jax_gaussians(trained):
    from pose_splatter_tpu.viz.export import extract_world_gaussians

    config, jm, variables = trained["config"], trained["jm"], trained["variables"]
    return {f: {k: np.asarray(v) for k, v in extract_world_gaussians(
        jm, variables, *_jax_frame(config, f)).items()} for f in (0, 1)}


@pytest.mark.parametrize("how", ["frame", "sequence"])
@pytest.mark.parametrize("fmt", ["npz", "ply_extended", "json", "ply"])
def test_export_gaussians(trained, jax_gaussians, tmp_path, how, fmt):
    """``--frame 1`` or ``--start 0 --end 2`` in every format. Each file
    holds the CLI's Gaussians, checked against the JAX extraction as npz;
    PLY and JSON files equal the JAX savers' output on them."""
    from pose_splatter_tpu.viz import export as jex

    cfg = trained["cfg"]
    frames = [1] if how == "frame" else [0, 1]
    span = (["--frame", "1"] if how == "frame"
            else ["--start", "0", "--end", "2"])
    out = tmp_path / fmt
    paths, _ = run_cli("export_gaussians", cfg, *span, "--format", fmt,
                       "--output_dir", str(out))
    ext = "npz" if fmt == "npz" else "ply" if fmt.startswith("ply") else "json"
    assert [os.path.basename(p) for p in paths] == [
        f"gaussian_frame{f:04d}.{ext}" for f in frames]
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p) for p in paths)
    for f, path in zip(frames, paths):
        # The CLI's Gaussians, as npz, against the JAX extraction.
        npz, _ = run_cli("export_gaussians", cfg, "--frame", str(f),
                         "--output_dir", str(tmp_path / "npz"))
        d = np.load(npz[0], allow_pickle=True)
        ref = jax_gaussians[f]
        assert len(d["means"]) == len(ref["means"]) >= 16
        for k in ("means", "quaternions", "scales", "opacities", "colors",
                  "center"):
            np.testing.assert_allclose(d[k], ref[k], rtol=0,
                                       atol=1e-5 * np.abs(ref[k]).max(),
                                       err_msg=k)
        if fmt != "npz":
            g = {k: d[k] for k in d.files if k != "metadata"}
            saver = {"ply_extended": jex.save_ply_extended, "json": jex.save_json,
                     "ply": jex.save_ply_pointcloud}[fmt]
            jfn = str(tmp_path / f"jax.{ext}")
            saver(g, jfn)
            assert open(path, "rb").read() == open(jfn, "rb").read()


@pytest.mark.parametrize("mode", ["360", "multiview", "temporal"])
def test_generate_videos(trained, mode):
    """The JAX script's frame names (ffmpeg is not on PATH here, so the
    PNGs stay); one frame of each mode against the JAX novel view."""
    from pose_splatter_tpu.viz.render_image import render_novel_view
    from pose_splatter_torch.scripts.common import full_res_intrinsics

    config, jm, variables = trained["config"], trained["jm"], trained["variables"]
    args = {"360": ["--frame", "3", "--steps", "2"],
            "multiview": ["--frame", "3"],
            "temporal": ["--start", "2", "--end", "4", "--view", "2"]}[mode]
    out_dir, _ = run_cli("generate_videos", mode, trained["cfg"], *args)
    names = {"360": ["rot_000.png", "rot_001.png"],
             "multiview": ["view_0.png", "view_1.png", "view_2.png"],
             "temporal": ["frame_00002.png", "frame_00003.png"]}[mode]
    assert out_dir == os.path.join(config.project_directory, f"video_{mode}")
    assert sorted(os.listdir(out_dir)) == names
    K_full = full_res_intrinsics(config)
    frame, view, kw = {"360": (3, 0, dict(angle_offset=np.pi)),
                       "multiview": (3, 1, {}),
                       "temporal": (3, 2, {})}[mode]
    ref = render_novel_view(jm, variables, *_jax_frame(config, frame, view),
                            view, K_full, IMG, IMG, **kw)
    _close_u8(_png(os.path.join(out_dir, names[1])), ref)
