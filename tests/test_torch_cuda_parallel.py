"""The parallel package on the card: one rank in a group of one over NCCL.

Every test is marked ``cuda`` and skips where no CUDA device is present.
On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda_parallel.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax; this file
imports only the port.) A second rank needs a second card: NCCL takes one
rank a card, so the decomposition over ranks is held on the CPU
(``test_torch_parallel_*.py``, gloo).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from pose_splatter_torch.graft_entry import dryrun_multichip
from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.ops.rasterize import _alpha_ellipse
from pose_splatter_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
)
from pose_splatter_torch.parallel.multihost import process_group
from pose_splatter_torch.parallel.tile_sharding import (
    _composite_local,
    _padded_origins,
    make_tile_sharded_train_step,
)
from pose_splatter_torch.scripts import dbg_highres_sharded, scaling
from pose_splatter_torch.train.loop import create_train_state, make_train_step
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames
from pose_splatter_torch.utils.geometry import create_3d_grid

pytestmark = pytest.mark.cuda

C, H, W = 3, 32, 64
KW = dict(ell=0.3, grid_size=16, min_n=32, max_n=512,
          volume_idx=[[0, 16]] * 3, num_unets=2, base_filters=4,
          holdout_views=[1], volume_fill_color=0.38, gaussian_mode="2d",
          gaussian_config={"view_anchored": True})


@pytest.fixture
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernels have no "
                    "CPU mode")
    with process_group("cuda") as dev:
        assert torch.distributed.get_backend() == "nccl"
        yield dev


def _model(dev, **kw):
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    return PoseSplatter(Ks, Es, W, H, device=dev, **dict(KW, **kw))


def _batch(n):
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    fr = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                          (0.09, 0.07, 0.06), n_frames=n, seed=0)
    obs = [0, 2]
    return dict(mask=fr["mask"][:, obs], img=fr["img"][:, obs],
                p_3d=fr["p_3d"], angle=fr["angle"],
                view_idx=np.array([0, 2] * (n // 2), np.int32),
                obs_idx=np.array([0, 1] * (n // 2), np.int32))


def test_dp_step_at_world_one_equals_make_train_step(group):
    """Two DP steps over NCCL at world 1 are bit-equal to two of the
    plain step from the same weights (cuDNN on deterministic algorithms):
    the all-reduces of one rank change nothing, and both run the
    compositor kernels."""
    a, b = _model(group), _model(group)
    b.net.load_state_dict(a.net.state_dict())
    mesh = make_mesh()
    sa = replicate_state(create_train_state(a, 1e-3), mesh)
    sb = create_train_state(b, 1e-3)
    dp = make_sharded_train_step(a, sa.optimizer, 0.5, 0.1, mesh)
    plain = make_train_step(b, sb.optimizer, 0.5, 0.1, batch_size=2)
    batch = _batch(2)
    launches = 0
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # twins compared bit for bit
    try:
        for _ in range(2):
            before = K.composite_instances.launches
            sa, ma = dp(sa, shard_batch(batch, mesh))
            launches += K.composite_instances.launches - before
            sb, mb = plain(sb, batch)
            assert float(ma["total"]) == float(mb["total"])
    finally:
        torch.backends.cudnn.deterministic = saved
    assert launches == 4  # 2 frames x 2 steps
    for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(x, y), k


def test_tile_step_kernel_against_tiled(group):
    """The (1, 1) tile step in kernel mode against the same step through
    the tiled compositor: losses within 1e-5 relative, updates within 1e-5
    of the largest, running statistics unchanged, the same overflow; the
    kernel step launches each compositor once a frame, the tiled one
    none."""
    mesh = make_mesh((1, 1), ("data", "tile"))
    models = [_model(group) for _ in range(2)]
    models[1].net.load_state_dict(models[0].net.state_dict())
    w0 = {k: v.clone() for k, v in models[0].net.state_dict().items()}
    losses, overflow, launches = [], [], []
    for m, comp in zip(models, ("kernel", "tiled")):
        st = create_train_state(m, 1e-3)
        step = make_tile_sharded_train_step(
            m, torch.optim.SGD(m.net.parameters(), lr=1.0), 0.5, 0.1, mesh,
            tile_shape=(8, 64), tile_capacity=256, chunk=64, compositor=comp)
        before = (K.composite_instances.launches,
                  K.composite_instances_bwd.launches)
        _, loss = step(st, _batch(2))
        launches.append((K.composite_instances.launches - before[0],
                         K.composite_instances_bwd.launches - before[1]))
        losses.append(float(loss))
        overflow.append(float(step.overflow))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    assert overflow[0] == overflow[1]
    assert launches == [(2, 2), (0, 0)]  # 2 frames
    sd = [m.net.state_dict() for m in models]
    top = max(float((sd[1][k] - w0[k]).abs().max()) for k in w0)
    for k in w0:
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(sd[0][k], w0[k]), k
            continue
        assert float((sd[0][k] - sd[1][k]).abs().max()) <= 1e-5 * top, k


def test_rank_local_shards_stitch(group):
    """``_composite_local`` over the 4 row-aligned shards of a tile grid,
    stitched, equals the same call over every tile at once (1e-6), one
    forward launch a shard."""
    rng = np.random.default_rng(0)
    n = 300
    dev = group
    mean2d = torch.as_tensor(rng.uniform(0, [W, 4 * H], (n, 2)),
                             dtype=torch.float32, device=dev)
    sc = torch.as_tensor(rng.uniform(0.5, 3, (n, 2)), dtype=torch.float32,
                         device=dev)
    theta = torch.as_tensor(rng.uniform(0, 3, n), dtype=torch.float32, device=dev)
    opac = torch.as_tensor(rng.uniform(0.1, 0.9, n), dtype=torch.float32,
                           device=dev)
    cols = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32,
                           device=dev)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    radius = 3 * torch.maximum(sc[:, 0], sc[:, 1])
    origins, n_ty, n_tx, pad = _padded_origins(4 * H, W, (8, 64), 4,
                                               row_aligned=True, device=dev)
    args = ((mean2d, sc, theta, opac), cols, ok, mean2d, radius,
            _alpha_ellipse, (8, 64), 256, 64, False, 0.0, "kernel")
    whole = _composite_local(origins, *args)
    T_l = origins.shape[0] // 4
    before = K.composite_instances.launches
    parts = [_composite_local(origins[i * T_l:(i + 1) * T_l], *args)
             for i in range(4)]
    assert K.composite_instances.launches - before == 4
    for j in range(2):
        torch.testing.assert_close(torch.cat([p[j] for p in parts]), whole[j],
                                   rtol=0, atol=1e-6)


def test_dryrun_multichip_one_rank(group, capsys):
    """Its two lines; the (data, tile) step launches each compositor once,
    the tiled data-parallel step none."""
    before = (K.composite_instances.launches,
              K.composite_instances_bwd.launches)
    dryrun_multichip(1, device=group)
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip(1) OK") == 2
    assert (K.composite_instances.launches - before[0],
            K.composite_instances_bwd.launches - before[1]) == (1, 1)


def test_scaling_and_highres_probe_at_one_rank(group):
    """``scripts/scaling.py`` (one row) and ``scripts/dbg_highres_sharded.py
    --devices 1`` at a small size run in the group of one: a positive rate,
    a finite loss."""
    with contextlib.redirect_stdout(io.StringIO()):
        report = scaling.main([])
        highres = dbg_highres_sharded.main([
            "--devices", "1", "--steps", "2", "--width", "96", "--height",
            "64", "--grid", "32", "--crop", "0,32,0,32,8,24", "--min-n", "16",
            "--max-n", "256", "--carve-cap", "0"])
    assert len(report["rows"]) == 1 and report["rows"][0]["steps_per_s"] > 0
    assert highres["loss_finite"]
