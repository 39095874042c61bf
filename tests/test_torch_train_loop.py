"""The port's loss gradients, checkpoints, data loader and
``train_from_config``: the gradients and the loader against the JAX
package, the rest by round trips, at a small size."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_tpu.data.dataset import FrameDataset as JDataset
from pose_splatter_tpu.data.dataset import FrameLoader as JLoader
from pose_splatter_tpu.ops.ssim import ssim as jssim
from pose_splatter_tpu.train.losses import total_loss as jtotal_loss
from pose_splatter_torch.config import Config
from pose_splatter_torch.data.dataset import FrameDataset, FrameLoader
from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.ops.ssim import ssim as tssim
from pose_splatter_torch.train.loop import (
    create_train_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from pose_splatter_torch.train.losses import total_loss as ttotal_loss
from pose_splatter_torch.train.trainer import train_from_config
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import (
    FrameSet,
    ring_cameras,
    synthetic_frames,
)

torch.set_num_threads(1)

C, H, W = 5, 48, 64
KW = dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
          volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="2d", gaussian_config={"view_anchored": True},
          holdout_views=[1], volume_fill_color=0.38)


def test_ssim_and_total_loss_gradients_match_jax():
    rng = np.random.default_rng(7)
    rgb = rng.uniform(0, 1, (24, 28, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (24, 28)).astype(np.float32)
    gt = np.where(rng.uniform(size=(24, 28, 1)) < 0.3, 1.0,
                  rng.uniform(0, 1, (24, 28, 3))).astype(np.float32)
    mask = (gt[..., 0] < 1.0).astype(np.float32)

    def jloss(r, a):
        return jtotal_loss(r, a, jnp.asarray(gt), jnp.asarray(mask), 0.5, 0.1)[0]

    ref_r, ref_a = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rgb),
                                                   jnp.asarray(alpha))
    ref_s = jax.grad(lambda r: jssim(r, jnp.asarray(gt)))(jnp.asarray(rgb))
    r = torch.from_numpy(rgb).requires_grad_(True)
    a = torch.from_numpy(alpha).requires_grad_(True)
    ttotal_loss(r, a, torch.from_numpy(gt), torch.from_numpy(mask), 0.5,
                0.1)[0].backward()
    r2 = torch.from_numpy(rgb).requires_grad_(True)
    tssim(r2, torch.from_numpy(gt)).backward()
    # Filters (forward and transposed) summed in another order; the L1
    # term's sign gradient is exact away from ties.
    for ref, got in ((ref_r, r.grad), (ref_a, a.grad), (ref_s, r2.grad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ref, got.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_ssim_backward_without_tf32(monkeypatch):
    """The SSIM filter's backward (a transposed conv) also runs with TF32
    off, though it runs after the forward's context has closed."""
    seen = []
    conv_t = torch.nn.functional.conv_transpose2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv_t(*args, **kwargs)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.nn.functional, "conv_transpose2d", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((16, 16, 3), generator=gen).requires_grad_(True)
    tssim(x, torch.rand((16, 16, 3), generator=gen)).backward()
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32


def _write_h5(tmp_path, T=7, C_=3, H_=8, W_=10):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    imgs = np.full((T, C_, H_, W_, 3), 255, np.uint8)
    imgs[:, :, 2:6, 3:8] = rng.integers(0, 250, (T, C_, 4, 5, 3))
    img_fn = str(tmp_path / "images.h5")
    with h5py.File(img_fn, "w") as f:
        f.create_dataset("images", data=imgs)
    np.savez(tmp_path / "cr.npz",
             centers=rng.normal(size=(T, 3)).astype(np.float32),
             angles=rng.uniform(-1, 1, T).astype(np.float32))
    return img_fn, str(tmp_path / "cr.npz")


# Split "all" enumerates every view, holdouts included, which the loader's
# observed-view table cannot place; it runs without holdouts.
@pytest.mark.parametrize("split,holdout,shuffle", [
    ("all", [], True), ("train", [1], False), ("test", [1], True)])
def test_frame_loader_matches_jax(tmp_path, split, holdout, shuffle):
    """The copied dataset and loader yield the JAX package's batches: the
    same frames, views (pre-drawn from the dataset's rng), masks and
    images, with two prefetch threads."""
    img_fn, cr_fn = _write_h5(tmp_path)
    kw = dict(holdout_views=holdout, split=split, seed=4)
    jds, tds = JDataset(img_fn, cr_fn, 3, **kw), FrameDataset(img_fn, cr_fn, 3, **kw)
    assert len(jds) == len(tds) > 0
    lkw = dict(batch_size=2, shuffle=shuffle, seed=5, prefetch=1, workers=2)
    ref = list(JLoader(jds, **lkw))
    got = list(FrameLoader(tds, **lkw))
    assert len(ref) == len(got) == len(jds) // 2
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            if k == "img":
                # The JAX package decodes with its native helper where it
                # is built (x · (1/255)); the copy divides: 1 ulp apart.
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def small(tmp_path):
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=4, seed=0)
    return Ks, Es, frames


def test_checkpoint_round_trip(small, tmp_path):
    Ks, Es, frames = small
    tm = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    state = create_train_state(tm, 1e-3)
    obs = tm.observed_views
    batch = dict(mask=frames["mask"][:1, obs], img=frames["img"][:1, obs],
                 p_3d=frames["p_3d"][:1], angle=frames["angle"][:1],
                 view_idx=np.array([obs[0]], np.int32),
                 obs_idx=np.array([0], np.int32))
    state, _ = make_train_step(tm, state.optimizer, 0.5, 0.1)(state, batch)
    path = str(tmp_path / "ck" / "model.ckpt")
    save_checkpoint(path, state, extra={"epoch": 3, "losses": [[1.0, 2.0, 3.0]]})

    fresh = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device="cpu",
                         seed=1, **KW)
    restored, extra = load_checkpoint(path, create_train_state(fresh, 1e-3))
    assert restored.step == 1 and extra["epoch"] == 3
    for (k, a), b in zip(tm.net.state_dict().items(),
                         fresh.net.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])


def _config(tmp_path, **kw):
    cfg = dict(project_directory=str(tmp_path), model_fn="checkpoint.pt",
               image_width=W, image_height=H, grid_size=KW["grid_size"],
               ell=KW["ell"], volume_idx=KW["volume_idx"],
               holdout_views=KW["holdout_views"],
               volume_fill_color=KW["volume_fill_color"],
               gaussian_mode="2d", gaussian_config={"view_anchored": True},
               min_n=KW["min_n"], max_n=KW["max_n"], num_unets=2,
               base_filters=4, lr=1e-3, img_lambda=0.5, ssim_lambda=0.1,
               valid_every=1, save_every=2)
    cfg.update(kw)
    return Config(cfg)


def test_train_from_config_two_epochs_and_resume(small, tmp_path, capsys):
    Ks, Es, frames = small
    train = FrameSet({k: v[:3] for k, v in frames.items()}, [0, 2, 3, 4])
    valid = FrameSet({k: v[3:] for k, v in frames.items()}, [0, 2, 3, 4],
                     split="valid")
    kw = dict(device="cpu", cameras=(Ks, Es), datasets=(train, valid),
              max_batches=2)
    config = _config(tmp_path)
    state, losses, vlosses = train_from_config(config, epochs=2, **kw)
    assert state.step == 4 and len(losses) == 2 and len(vlosses) == 2
    assert all(np.isfinite(x) for row in losses for x in row)
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "epoch 2:" in out and "validation:" in out
    # The fresh start: near-identity U-Nets, heads near 0 (anchored means
    # start at the anchors), the shared log-scale at log 2.
    net = state.model.net
    assert float(net.head2.bias.abs().max()) < 0.1
    ckpt = tmp_path / "checkpoint.ckpt"
    assert ckpt.exists()
    meta = json.loads((tmp_path / "checkpoint.ckpt.meta.json").read_text())
    assert meta["epoch"] == 2 and len(meta["losses"]) == 2
    saved = {k: v.clone() for k, v in net.state_dict().items()}

    state2, losses2, _ = train_from_config(config, epochs=1, load=True, **kw)
    assert state2.step == 6 and len(losses2) == 3
    assert losses2[:2] == meta["losses"]
    moved = [k for k, v in state2.model.net.state_dict().items()
             if not torch.equal(v, saved[k])]
    assert moved  # training went on from the checkpoint
    assert "Loaded checkpoint from epoch 2." in capsys.readouterr().out


@pytest.mark.parametrize("key", ["remat_unets", "adaptive_camera"])
def test_train_from_config_runs_remat_and_adaptive(small, tmp_path, key):
    """Each key reaches the model that ``train_from_config`` trains, and an
    epoch of two steps and a validation pass run with it."""
    Ks, Es, frames = small
    data = FrameSet(frames, [0, 2, 3, 4])
    state, losses, vlosses = train_from_config(
        _config(tmp_path, **{key: True}), epochs=1, device="cpu",
        cameras=(Ks, Es), datasets=(data, data), max_batches=2)
    model = state.model
    assert (model.net.remat if key == "remat_unets" else model.adaptive_camera)
    assert state.step == 2 and np.isfinite(losses[0]).all()
    assert np.isfinite(vlosses[0])
