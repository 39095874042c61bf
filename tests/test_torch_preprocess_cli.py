"""Every subcommand of the port's preprocessing CLI
(``python -m pose_splatter_torch.scripts.preprocess``, called in process
with ``--device cpu``) on a synthetic video project, its files against what
the JAX package's functions write on a twin project.

The twin projects share the videos; each has its own camera files. From
``crop_indices`` on, both read the JAX package's ``center_rotation.npz``
(the port's own is held against it in ``center_rotation``), so that each
later file is compared on the same inputs. ``visual_features`` renders the
32-view rig in ``"tiled"`` mode in both packages (the config's
``render_mode``; kernel mode is held in ``test_torch_visual_features.py``)
for one frame of a model with up to 64 Gaussians. ``visual_embedding``
runs on seeded features of every frame (PCA, t-SNE and the plot need more
than one), and skips without sklearn. ``write_images`` runs two joblib
workers in each package.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_splatter_torch.scripts import preprocess as cli
from test_torch_preprocess import make_video_project

torch.set_num_threads(1)

T = 36  # frames: the crop step reads the first third
STEPS = ("convert_cameras", "auto_up", "center_rotation", "crop_indices",
         "write_images", "to_zarr", "visual_features", "visual_embedding")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("cv2")
    h5py = pytest.importorskip("h5py")
    from pose_splatter_tpu.config import Config as JConfig
    from pose_splatter_tpu.models.resnet import ResNet18
    from pose_splatter_tpu.preprocess import center_rotation as jcr
    from pose_splatter_tpu.preprocess import crop_indices as jci
    from pose_splatter_tpu.preprocess import visual_features as jvf
    from pose_splatter_tpu.preprocess import write_images as jwi
    from pose_splatter_tpu.preprocess.cameras import convert_camera_params
    from pose_splatter_tpu.preprocess.up_direction import auto_estimate_up
    from pose_splatter_tpu.train import trainer as jtrainer
    from pose_splatter_torch.bridge import resnet_from_flax, variables_from_flax
    from pose_splatter_torch.config import Config as TConfig
    from pose_splatter_torch.train.loop import create_train_state, save_checkpoint
    from pose_splatter_torch.train.trainer import build_model, checkpoint_path
    from test_torch_unet_bridge import random_variables

    root = tmp_path_factory.mktemp("cli_project")
    _, project = make_video_project(root, T=T, min_n=16, max_n=64,
                                    max_frames=1, render_mode="tiled")
    jpath, tpath = project("jax"), project("torch")
    jcfg, tcfg = JConfig(jpath), TConfig(tpath)
    out = {"configs": (jcfg, tcfg)}

    def run_cli(*args):
        cli.main([*args, "--device", "cpu"])

    # convert_cameras: a pickle of the cameras, as the rig's export holds them.
    with h5py.File(tcfg.camera_fn, "r") as f:
        g = f["camera_parameters"]
        cams = [dict(K=K, R=R, T=t[:, None]) for K, R, t in
                zip(g["intrinsic"][:], g["rotation"][:], g["translation"][:])]
    pkl = root / "cams.pkl"
    pkl.write_bytes(pickle.dumps(cams))
    run_cli("convert_cameras", str(pkl), str(root / "t_cams.h5"))
    convert_camera_params(str(pkl), str(root / "j_cams.h5"))
    out["convert_cameras"] = (str(root / "j_cams.h5"), str(root / "t_cams.h5"))

    run_cli("auto_up", tpath)
    auto_estimate_up(jcfg.camera_fn, jcfg.vertical_lines_fn)

    run_cli("center_rotation", tpath)
    jcr.calculate_center_rotation(jcfg, progress=False)
    out["center_rotation"] = dict(np.load(tcfg.center_rotation_fn))
    shutil.copy(jcfg.center_rotation_fn, tcfg.center_rotation_fn)

    run_cli("crop_indices", tpath, "--force")
    jci.calculate_volume_sum(jcfg)

    # Two joblib workers in each package (n_jobs is the CPU count).
    mp = pytest.MonkeyPatch()
    mp.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    try:
        run_cli("write_images", tpath)
        jwi.write_images(jcfg, n_jobs=2)
    finally:
        mp.undo()

    h5 = os.path.join(tcfg.image_directory, "images.h5")
    run_cli("to_zarr", tpath)
    out["to_zarr"] = (jwi.copy_h5_to_zarr(os.path.join(jcfg.image_directory,
                                                       "images.h5")), h5)

    # visual_features: the port's checkpoint of bridged weights; ResNet18
    # weights from one .npz.
    jm = jtrainer.build_model(jcfg)
    variables = random_variables(jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0,
                                 train=False)
    variables["params"]["scale"] = np.full((1,), np.log(0.006), np.float32)
    tm = build_model(tcfg, device="cpu")
    tm.net.load_state_dict(variables_from_flax(variables))
    save_checkpoint(checkpoint_path(tcfg, False), create_train_state(tm, 1e-4))
    rvars = random_variables(ResNet18(), jnp.zeros((1, 64, 64, 3)), seed=1,
                             train=False)
    weights = str(root / "resnet18.npz")
    np.savez(weights, **{k: v.numpy() for k, v in resnet_from_flax(rvars).items()})
    run_cli("visual_features", tpath, "--resnet_weights", weights)
    (jdset,) = jtrainer.build_datasets(jcfg, splits=("all_volumes",))
    jvf.calculate_visual_features(jcfg, jm, variables, jdset,
                                  resnet_weights=weights, progress=False)
    out["visual_features"] = (np.load(jcfg.feature_fn), np.load(tcfg.feature_fn))

    try:
        import sklearn  # noqa: F401
    except ImportError:
        out["visual_embedding"] = None
    else:
        from pose_splatter_tpu.preprocess.visual_embedding import (
            calculate_visual_embedding,
        )

        feats = np.random.default_rng(2).normal(size=(T, 4, 8)).astype(np.float16)
        for cfg in (jcfg, tcfg):
            np.save(cfg.feature_fn, feats)
        run_cli("visual_embedding", tpath)
        calculate_visual_embedding(jcfg)
        out["visual_embedding"] = (np.load(jcfg.embedding_fn),
                                   np.load(tcfg.embedding_fn))
    return out


def test_every_subcommand_is_tested():
    """The CLI has the JAX script's eight subcommands, each with --device."""
    sub = cli.build_parser()._subparsers._group_actions[0]
    assert set(sub.choices) == set(STEPS)
    for name, p in sub.choices.items():
        assert p.get_default("fn") is not None, name
        assert any("--device" in a.option_strings for a in p._actions), name


def test_convert_cameras(runs):
    import h5py

    jfn, tfn = runs["convert_cameras"]
    with h5py.File(jfn, "r") as j, h5py.File(tfn, "r") as t:
        for k in ("intrinsic", "rotation", "translation"):
            np.testing.assert_array_equal(t["camera_parameters"][k][:],
                                          j["camera_parameters"][k][:])


def test_auto_up(runs):
    jcfg, tcfg = runs["configs"]
    np.testing.assert_array_equal(np.load(tcfg.vertical_lines_fn)["up"],
                                  np.load(jcfg.vertical_lines_fn)["up"])


def test_center_rotation(runs):
    jcfg, _ = runs["configs"]
    ref, got = np.load(jcfg.center_rotation_fn), runs["center_rotation"]
    assert got["centers"].shape == (T, 3)
    np.testing.assert_allclose(got["angles"], ref["angles"], rtol=0, atol=1e-5)
    for k in ("centers", "covs"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref[k]).max()))


def test_crop_indices(runs):
    jcfg, tcfg = runs["configs"]
    ref, got = np.load(jcfg.volume_sum_fn), np.load(tcfg.volume_sum_fn)
    np.testing.assert_array_equal(got, ref)
    assert int(got.max()) == T // 3


def test_write_images(runs):
    import h5py

    jcfg, tcfg = runs["configs"]
    with h5py.File(os.path.join(jcfg.image_directory, "images.h5"), "r") as j, \
            h5py.File(os.path.join(tcfg.image_directory, "images.h5"), "r") as t:
        assert t["images"].shape == (T, 4, 48, 64, 3)
        np.testing.assert_array_equal(t["images"][:], j["images"][:])
    assert sorted(os.listdir(tcfg.image_directory)) == sorted(
        os.listdir(jcfg.image_directory))


def test_to_zarr(runs):
    """Without zarr both packages keep images.h5; with it, both copies hold
    the same array."""
    jout, h5 = runs["to_zarr"]
    jcfg, tcfg = runs["configs"]
    tout = h5[:-3] + ".zarr" if os.path.exists(h5[:-3] + ".zarr") else h5
    assert os.path.basename(tout) == os.path.basename(jout)
    if tout.endswith(".zarr"):
        import zarr

        np.testing.assert_array_equal(zarr.open(tout, "r")["images"][:],
                                      zarr.open(jout, "r")["images"][:])


def test_visual_features(runs):
    """float16 files of one frame, [16, 512] at L = 3, within 1e-4 of the
    largest plus 1 ULP (the float16 cast of float32 values that agree
    within 1e-4 of the largest, the bound of the kernel-mode test)."""
    ref, got = runs["visual_features"]
    assert got.shape == ref.shape == (1, 16, 512) and got.dtype == np.float16
    ulp = np.maximum(np.spacing(np.abs(ref)), np.spacing(np.abs(got)))
    d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    assert np.all(d <= ulp.astype(np.float32)
                  + 1e-4 * float(np.abs(ref.astype(np.float32)).max()))
    assert float(np.abs(ref.astype(np.float32)).max()) > 0


def test_visual_embedding(runs):
    if runs["visual_embedding"] is None:
        pytest.skip("sklearn is not installed")
    ref, got = runs["visual_embedding"]
    assert got.shape == (T, 32)  # PCA and AAPCA keep min(T, 4·8) components
    np.testing.assert_array_equal(got, ref)
