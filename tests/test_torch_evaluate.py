"""The port's evaluation metrics (``train/evaluate.py``:
``calculate_image_metrics``, ``calculate_lpips_metric``,
``write_evaluation_summary``) against the JAX package's on the same two
``images.h5`` files: 9 frames of 3 cameras at 48x64 (AlexNet's
smallest input), seeded uint8 renders
(RGBA) and ground truth with a white background.

The per-camera metrics agree at rtol 1e-5 (float32 sums in another
order), the CSV's header exactly and its ``%.6f`` values within one unit
of the last place; LPIPS (a seeded AlexNet ``.npz``) at rtol 1e-5.

SSIM (a value in [-1, 1]) is held within 1e-4 absolute: both packages
take the variances as E[x²] − μ² in float32, which cancels on the white
background (x = 1), and XLA's convolution rounds otherwise than
PyTorch's; the two differ by about 6e-5 here. Against SSIM in float64 the
port is within 2e-5 relative and nearer to it than the JAX package on
every camera (``test_ssim_metric_against_float64``).
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose_splatter_tpu.ops import lpips as jlpips
from pose_splatter_tpu.train import evaluate as jev
from pose_splatter_torch.train import evaluate as tev

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)

T, C, H, W = 9, 3, 48, 64
SPLITS = ("train", "valid", "test")
TOL = dict(l1=(1e-5, 0), iou=(1e-5, 0), soft_iou=(1e-5, 0), psnr=(1e-5, 0),
           ssim=(0, 1e-4))  # (rtol, atol)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """images.h5 pairs: a textured blob on white in the ground truth, and
    renders that are the ground truth plus noise, with an alpha that
    covers the blob roughly."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    gt = np.full((T, C, H, W, 3), 255, np.uint8)
    alpha = np.zeros((T, C, H, W), np.float32)
    for t in range(T):
        for c in range(C):
            cy, cx = rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(80, 160)
            gt[t, c][blob] = rng.integers(0, 250, (int(blob.sum()), 3))
            alpha[t, c] = np.clip(blob + rng.normal(0, 0.3, (H, W)), 0, 1)
    rgb = np.clip(gt.astype(np.float32) + rng.normal(0, 20, gt.shape), 0, 255)
    pred = np.concatenate([rgb, 255 * alpha[..., None]], -1).astype(np.uint8)
    root = tmp_path_factory.mktemp("eval")
    paths = {}
    for name, arr in (("pred", pred), ("gt", gt)):
        paths[name] = str(root / f"{name}.h5")
        with h5py.File(paths[name], "w") as f:
            f.create_dataset("images", data=arr)
    paths["root"] = root
    return paths


@pytest.mark.parametrize("split", SPLITS)
def test_calculate_image_metrics_matches_jax(files, split):
    root = files["root"]
    ref = jev.calculate_image_metrics(files["pred"], files["gt"],
                                      str(root / f"j_{split}.csv"),
                                      split=split, progress=False)
    got = tev.calculate_image_metrics(files["pred"], files["gt"],
                                      str(root / f"t_{split}.csv"),
                                      split=split, progress=False,
                                      device="cpu")
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == (C,) and got[k].dtype == np.float64
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    jcsv = (root / f"j_{split}.csv").read_text().splitlines()
    tcsv = (root / f"t_{split}.csv").read_text().splitlines()
    assert tcsv[0] == jcsv[0] == "# iou\tl1\tpsnr\tsoft_iou\tssim"
    tvals = np.loadtxt(tcsv[1:], delimiter=",")
    jvals = np.loadtxt(jcsv[1:], delimiter=",")
    assert tvals.shape == (C, 5)
    for i, k in enumerate(sorted(TOL)):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(tvals[:, i], jvals[:, i], rtol=rtol,
                                   atol=atol + 1.01e-6, err_msg=k)


def _ssim64(pred, gt):
    """SSIM of two [H,W,3] images in float64 (the same window and
    constants as ``ops/ssim.py``)."""
    from pose_splatter_torch.ops.ssim import _gaussian_kernel

    k = _gaussian_kernel(11, 1.5).double()[None, None].expand(3, 1, 11, 11)

    def f(x):
        return F.conv2d(x.permute(0, 3, 1, 2), k, groups=3)

    x = torch.tensor(pred, dtype=torch.float64)[None]
    y = torch.tensor(gt, dtype=torch.float64)[None]
    mx, my = f(x), f(y)
    sxx, syy, sxy = f(x * x) - mx * mx, f(y * y) - my * my, f(x * y) - mx * my
    c1, c2 = 1e-4, 9e-4
    return float((((2 * mx * my + c1) * (2 * sxy + c2))
                  / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean())


def test_ssim_metric_against_float64(files):
    """Why SSIM is held within 1e-4: the port's float32 SSIM is within 2e-5 of
    float64 and nearer to it than the JAX package's on every camera."""
    with h5py.File(files["pred"]) as p, h5py.File(files["gt"]) as g:
        pred, gt = p["images"][:] / 255.0, g["images"][:] / 255.0
    i1, i2 = tev.split_range(T, "test")
    ref = np.array([np.mean([_ssim64(pred[t, c, ..., :3], gt[t, c])
                             for t in range(i1, i2)]) for c in range(C)])
    got = tev.image_metrics((pred * 255).round().astype(np.uint8),
                            (gt * 255).round().astype(np.uint8),
                            device="cpu")["ssim"]
    jax_ssim = np.asarray(jev.calculate_image_metrics(
        files["pred"], files["gt"], str(files["root"] / "f64.csv"),
        progress=False)["ssim"])
    np.testing.assert_allclose(got, ref, rtol=2e-5)
    assert (np.abs(got - ref) <= np.abs(jax_ssim - ref)).all()


def test_image_metrics_in_memory_equals_the_files(files):
    """The array half reads numpy arrays as it reads the HDF5 datasets."""
    with h5py.File(files["pred"]) as p, h5py.File(files["gt"]) as g:
        pred, gt = p["images"][:], g["images"][:]
    mem = tev.image_metrics(pred, gt, split="test", device="cpu")
    disk = tev.calculate_image_metrics(files["pred"], files["gt"],
                                       str(files["root"] / "m.csv"),
                                       progress=False, device="cpu")
    for k in disk:
        np.testing.assert_array_equal(mem[k], disk[k])
    with pytest.raises(ValueError):
        tev.image_metrics(pred[:, :2], gt, device="cpu")


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    rng = np.random.default_rng(6)
    d, cin = {}, 3
    for i, (f, k, _, _) in enumerate(jlpips._ALEX_CFG):
        d[f"conv{i}_kernel"] = rng.normal(0, (cin * k * k) ** -0.5,
                                          (k, k, cin, f)).astype(np.float32)
        d[f"conv{i}_bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        d[f"lin{i}"] = rng.uniform(0, 1, f).astype(np.float32)
        cin = f
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    np.savez(path, **d)
    return path


def test_calculate_lpips_metric_matches_jax(files, lpips_weights):
    ref = jev.calculate_lpips_metric(files["pred"], files["gt"], lpips_weights,
                                     split="test", batch_size=2)
    got = tev.calculate_lpips_metric(files["pred"], files["gt"], lpips_weights,
                                     split="test", batch_size=2, device="cpu")
    assert got.shape == (C,) and (got > 0).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_calculate_lpips_metric_without_weights_is_none(files, tmp_path):
    for weights in (None, str(tmp_path / "missing.npz")):
        assert jev.calculate_lpips_metric(files["pred"], files["gt"],
                                          weights) is None
        assert tev.calculate_lpips_metric(files["pred"], files["gt"], weights,
                                          device="cpu") is None


def test_write_evaluation_summary_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    metrics = {k: rng.uniform(0, 30, C) for k in ("l1", "psnr", "lpips")}
    extra = {"split": "test", "frames": 3}
    jev.write_evaluation_summary(metrics, str(tmp_path / "j.json"), extra)
    tev.write_evaluation_summary(metrics, str(tmp_path / "t.json"), extra)
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert got["psnr"]["per_camera"] == [float(x) for x in metrics["psnr"]]
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
