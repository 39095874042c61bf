"""The port's native frame decode (``pose_splatter_torch/data/native.py``,
built from ``csrc/fastio.cpp``) against the JAX package's
(``pose_splatter_tpu/data/native.py``) and against NumPy, on the CPU.

- ``decode_frame`` and ``white_out`` are bit-equal to the JAX package's
  where both libraries build, for every byte value and thread count.
- Against NumPy the image differs only on the byte values where
  ``r · (1/255) ≠ r / 255`` (126 of 256), by one ulp, and the mask is
  exact.
- The library lands under ``build/native/``; the JAX package's
  ``native/`` directory is never written. Where it does not build, the
  NumPy versions run and ``route()`` says so.
- ``data/dataset.py::decode_frame`` dispatches to it.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_tpu.data import native as jnative
from pose_splatter_torch.data import dataset as tdataset
from pose_splatter_torch.data import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native decode cannot build here")
    assert native.available(), "g++ is present but the library did not build"
    return native


@pytest.fixture(scope="module")
def both(built):
    if not jnative.available():
        pytest.skip("the JAX package's libfastio.so did not build")
    return built


def every_byte(C=3, H=16, W=48, seed=0):
    """uint8 [C,H,W,3] holding every byte value in each channel, white
    background rows and random pixels."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (C, H, W, 3), dtype=np.uint8)
    raw[0, :2] = 255
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    raw[1, :, :16] = ramp[..., None]
    return raw


@pytest.mark.parametrize("n_threads", [0, 1, 2, 5])
def test_decode_frame_bit_equal_to_jax(both, n_threads):
    raw = every_byte(C=5)
    mask, img = native.decode_frame(raw, n_threads=n_threads)
    jmask, jimg = jnative.decode_frame(raw, n_threads=n_threads)
    assert img.dtype == jimg.dtype == np.float32
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(mask, jmask)


def test_white_out_bit_equal_to_jax(both):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 24, 24, 3), dtype=np.uint8)
    masks = rng.integers(0, 256, (3, 24, 24), dtype=np.uint8)
    got = native.white_out(frames.copy(), masks)
    np.testing.assert_array_equal(got, jnative.white_out(frames.copy(), masks))
    np.testing.assert_array_equal(
        got, native.white_out_numpy(frames.copy(), masks))
    assert (got[masks < 128] == 255).all()


def test_decode_against_numpy_differs_by_one_ulp_where_scaling_differs(built):
    raw = every_byte()
    mask, img = native.decode_frame(raw)
    ref_mask, ref_img = native.decode_frame_numpy(raw)
    np.testing.assert_array_equal(mask, ref_mask)
    values = np.arange(256, dtype=np.float32)
    differs = values * (np.float32(1) / np.float32(255)) != values / 255
    assert differs.sum() == 126
    expected = differs[raw]
    np.testing.assert_array_equal(img != ref_img, expected)
    gap = np.abs(img - ref_img)[expected]
    np.testing.assert_array_equal(gap, np.spacing(ref_img[expected]))
    assert gap.max() <= 5.97e-8


def test_library_under_build_and_native_untouched(built, tmp_path,
                                                  monkeypatch):
    """A fresh build writes only under the build directory; the JAX
    package's ``native/`` keeps its files and their times."""
    assert native.library_path().parent == ROOT / "build" / "native"
    assert Path(native._load()._name) == native.library_path()

    def snapshot():
        return {p.name: p.stat().st_mtime_ns
                for p in (ROOT / "native").iterdir()}

    before = snapshot()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    lib = native.build()
    assert lib.parent == tmp_path / "native" and lib.exists()
    assert Path(str(lib) + ".log").exists()
    assert native.build() == lib  # built once, then found by its hash
    assert snapshot() == before


def test_failed_build_falls_back_to_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CXX", "false")
    assert native.route() == "numpy" and not native.available()
    raw = every_byte()
    for a, b in zip(native.decode_frame(raw), native.decode_frame_numpy(raw)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdataset.decode_frame(raw),
                    native.decode_frame_numpy(raw)):
        np.testing.assert_array_equal(a, b)
    assert list(tmp_path.iterdir()) == []


def test_dataset_decode_takes_the_native_route(built):
    raw = every_byte(seed=3)
    assert native.route() == "native"
    for a, b in zip(tdataset.decode_frame(raw), native.decode_frame(raw)):
        np.testing.assert_array_equal(a, b)


def test_inputs_are_checked(built):
    with pytest.raises(ValueError, match="uint8"):
        native.decode_frame(np.zeros((2, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="masks"):
        native.white_out(np.zeros((2, 4, 4, 3), np.uint8),
                         np.zeros((2, 4, 5), np.uint8))


def test_default_threads_follow_the_affinity():
    cpus = len(os.sched_getaffinity(0))
    assert native._threads(0, 64) == min(64, cpus)
    assert native._threads(0, 1) == 1 and native._threads(3, 64) == 3
