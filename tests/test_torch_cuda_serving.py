"""Serving a sequence and its input side on the card: the native frame
decode built on the card's machine against NumPy, a tiny temporal sequence
on the card against the CPU, ``doctor`` and the input-pipeline probe at a
small size.

Every test is marked ``cuda`` and skips where no CUDA device is present.
On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda_serving.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax, which such a
machine need not have; this file imports only the port.)
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.data import native
from pose_splatter_torch.models.pose_splatter import init_means2d_center
from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.scripts import dbg_input_pipeline as ip
from pose_splatter_torch.scripts import synthetic_benchmark as sb
from pose_splatter_torch.scripts import temporal_benchmark as tb

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
C, H, W, T, GRID, LENGTH = 3, 32, 48, 2, 16, 6
SCENE = dict(cameras=C, width=W, height=H, grid=GRID, mode="2d", frames=T,
             crop=None, anchored=True, radii=[0.10, 0.05, 0.04], min_n=8,
             max_n=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def test_native_decode_builds_and_differs_from_numpy_by_one_ulp(dev):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    assert native.route() == "native"
    assert native.library_path().parent == ROOT / "build" / "native"
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (6, 64, 80, 3), dtype=np.uint8)
    raw[0, :4] = 255
    mask, img = native.decode_frame(raw)
    ref_mask, ref_img = native.decode_frame_numpy(raw)
    np.testing.assert_array_equal(mask, ref_mask)
    differs = img != ref_img
    values = np.arange(256, dtype=np.float32)
    np.testing.assert_array_equal(
        differs, (values * (np.float32(1) / np.float32(255))
                  != values / 255)[raw])
    np.testing.assert_array_equal(np.abs(img - ref_img)[differs],
                                  np.spacing(ref_img[differs]))


@pytest.fixture
def state(tmp_path):
    torch.manual_seed(0)
    model = sb.build_model(C, H, W, GRID, "2d", holdout=C - 1, anchored=True,
                           min_n=8, max_n=64, device="cpu")
    init_means2d_center(model.net, W, H, anchored=True)
    fn = tmp_path / "state.pt"
    torch.save(dict(
        params={k: v.detach() for k, v in model.net.named_parameters()},
        batch_stats={k: v.detach() for k, v in model.net.named_buffers()},
        scene=SCENE), fn)
    return str(fn)


def test_temporal_sequence_card_against_cpu(dev, state):
    """Each frame's held-out render on the card within 1e-5 of the CPU's,
    one forward-kernel launch a frame, the uint8 sequence within one level
    and the quality pass within 1e-4."""
    _, _, frames, centers, angles = sb.make_scene(C, H, W, T=T)
    runs = {}
    for device in ("cuda", "cpu"):
        model, _ = tb.load_state(state, device)
        read = tb.staged_reader(model, frames, centers, angles)
        rgbs = [model(*read(i), C - 1)[0][0].cpu() for i in range(T)]
        seq = {}
        before = K.composite_instances.launches
        tb.run_sequence(tb.make_render_u8(model, C - 1), read, LENGTH,
                        lambda i, x: seq.__setitem__(i, x))
        launches = K.composite_instances.launches - before
        q = tb.quality(model, frames, centers, angles, C - 1)
        runs[device] = (rgbs, seq, launches, q)
    (rc, sc, lc, qc), (rp, sp, lp, qp) = runs["cuda"], runs["cpu"]
    assert lc == LENGTH and lp == 0
    for a, b in zip(rc, rp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert sorted(sc) == sorted(sp) == list(range(LENGTH))
    for i in range(LENGTH):
        assert np.abs(sc[i].astype(int) - sp[i]).max() <= 1
    for k in ("psnr", "ssim", "iou"):
        assert abs(qc[k] - qp[k]) <= 1e-4, k


def test_temporal_main_on_the_card(dev, state, capsys):
    """The default mode's report; one forward launch a frame of the
    quality pass (the scene's frames) and of the sequence."""
    before = K.composite_instances.launches
    rep = tb.main(["--state", state, "--length", "4"])
    assert K.composite_instances.launches - before == T + 4
    assert rep["backend"] == "cuda" and rep["decode"] == "numpy"
    assert rep["sequence_frames"] == 4 and rep["ms_per_frame"] > 0


def test_doctor_exits_0(dev):
    proc = subprocess.run(
        [sys.executable, "-m", "pose_splatter_torch.scripts.doctor"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "through composite_fwd / composite_bwd" in proc.stdout


def test_input_probe_small(dev, tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    for k, v in dict(C=3, H=64, W=96, GRID=32, CROP="0,32,0,32,0,16",
                     STEP_REPS=2).items():
        monkeypatch.setattr(ip, k, v)
    images = np.stack(list(ip.make_frames(6)))
    poses = ip.make_poses(6)

    class Memory:
        """The dataset interface ``FrameLoader`` reads, over the frames in
        memory (the card's machine may lack h5py)."""
        split, C = "train", 3
        observed_views = np.array([0, 1])
        _rng = np.random.default_rng(0)

        def __len__(self):
            return 2

        def get(self, idx, view_idx=None):
            from pose_splatter_torch.data.dataset import decode_frame

            mask, img = decode_frame(images[idx])
            view = view_idx if view_idx is not None else 0
            return (mask[:2], img[:2], poses["centers"][idx],
                    float(poses["angles"][idx]), view)

    before = (K.composite_instances.launches,
              K.composite_instances_bwd.launches)
    m = ip.measure(Memory(), 4, 2, dev)
    launched = (K.composite_instances.launches - before[0],
                K.composite_instances_bwd.launches - before[1])
    assert launched[1] >= 3 and launched[0] >= launched[1]
    rep = ip.make_report(m, 2, dev)
    assert rep["backend"] == "cuda" and rep["decode"] == "native"
    assert all(np.isfinite([m["data_ms"], m["step_ms"], m["overlapped_ms"]]))
