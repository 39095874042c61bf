"""One rank of the port's multi-rank tests (``tests/test_torch_parallel_*.py``).

    python tests/torch_parallel_worker.py <task> <dir>

Started by ``pose_splatter_torch.parallel.launch.launch`` (gloo on the
CPU, one thread a rank). It reads the inputs that the test process wrote
into ``<dir>`` (numpy files made from seeded generators, weights moved
through the bridge), runs ``<task>`` in this rank and writes its results to
``<dir>/rank<r>.npz``. It imports no JAX: the test process holds the
results against the JAX package.

The models and scenes are defined here so that the test process builds
the same ones on the JAX side.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pose_splatter_torch.utils.synthetic import (  # noqa: E402
    ring_cameras,
    synthetic_frames,
)
from pose_splatter_torch.utils.geometry import create_3d_grid  # noqa: E402

# The 3D model of test_torch_model_3d.py (its seeded scene holds no
# pixel-Gaussian pair on a conic gate) and a view-anchored 2D model.
C = 3
SIZE3 = (32, 32)  # H, W
SIZE2 = (40, 64)  # 5 rows of (8, 64) tiles: padded to 6 over 2 ranks
COMMON = dict(ell=0.3, grid_size=16, min_n=32, max_n=512,
              volume_idx=[[0, 16]] * 3, num_unets=2, base_filters=4,
              holdout_views=[1], volume_fill_color=0.38)
KW3 = dict(COMMON, gaussian_mode="3d")
KW2 = dict(COMMON, gaussian_mode="2d", gaussian_config={"view_anchored": True})
AXES = (0.09, 0.07, 0.06)
SCALE = {"3d": np.log(0.03), "2d": np.log(2.0)}  # the shared log-scale
LR_ADAM = 1e-3
IMG_LAMBDA = 0.5


def cameras(mode):
    H, W = SIZE3 if mode == "3d" else SIZE2
    return ring_cameras(C, W, H, focal=60.0, radius=0.6)


def frames(mode, n, seed=0):
    """n frames of the seeded ellipsoid: a batch dict of numpy arrays
    (observed views only, each frame rendering observed view f % 2)."""
    H, W = SIZE3 if mode == "3d" else SIZE2
    Ks, Es = cameras(mode)
    grid = create_3d_grid(COMMON["ell"], COMMON["grid_size"],
                          COMMON["volume_idx"])
    fr = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0), AXES,
                          n_frames=n, seed=seed)
    obs = [i for i in range(C) if i not in COMMON["holdout_views"]]
    f = np.arange(n) % len(obs)
    return dict(mask=fr["mask"][:, obs], img=fr["img"][:, obs],
                p_3d=fr["p_3d"], angle=fr["angle"],
                view_idx=np.asarray(obs, np.int32)[f],
                obs_idx=f.astype(np.int32))


def scene(n=60, seed=0):
    """The Gaussians of test_sharding.py's tile tests."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(0, 0.3, (n, 3)) + [0, 0, 2.0]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.3, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


def strip_tiles(img, tile_shape, n_dev):
    """[B,H,W,c] images → [B, T', th·tw, c] row-aligned tile strips, the
    pad tiles zero (what the tile step's target strips hold)."""
    B, H, W, c = img.shape
    th, tw = tile_shape
    n_ty, n_tx = -(-H // th), -(-W // tw)
    n_ty_pad = -(-n_ty // n_dev) * n_dev
    full = np.zeros((B, n_ty_pad * th, n_tx * tw, c), img.dtype)
    full[:, :H, :W] = img
    return (full.reshape(B, n_ty_pad, th, n_tx, tw, c)
            .transpose(0, 1, 3, 2, 4, 5).reshape(B, n_ty_pad * n_tx, th * tw, c))


def _model(mode, render_mode, **kw):
    from pose_splatter_torch.models.pose_splatter import PoseSplatter

    H, W = SIZE3 if mode == "3d" else SIZE2
    Ks, Es = cameras(mode)
    return PoseSplatter(Ks, Es, W, H, render_mode=render_mode, device="cpu",
                        **(KW3 if mode == "3d" else KW2), **kw)


def _load(path):
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k]) for k in z.files}


def _state(model, weights, opt):
    from pose_splatter_torch.train.loop import TrainState, adam

    model.net.load_state_dict(weights)
    params = list(model.net.parameters())
    optimizer = (torch.optim.SGD(params, lr=1.0) if opt == "sgd"
                 else adam(params, LR_ADAM))
    return TrainState(step=0, model=model, optimizer=optimizer)


def _record(out, case, model):
    for k, v in model.net.state_dict().items():
        out[f"{case}.{k}"] = v.detach().numpy()


def task_dp(d, rank, out):
    """Data-parallel steps over every rank (one ``data`` axis)."""
    from pose_splatter_torch.parallel import (
        assemble_global_batch,
        global_mesh,
        make_mesh,
        make_sharded_train_step,
        process_local_indices,
        replicate_state,
        shard_batch,
    )

    weights = _load(os.path.join(d, "weights3d.npz"))
    with np.load(os.path.join(d, "batch3d.npz")) as z:
        batch = {k: z[k] for k in z.files}
    mesh = make_mesh()
    for case in ("global-sgd", "global-adam", "kernel-sgd"):
        render, opt = case.split("-")
        model = _model("3d", render)
        state = replicate_state(_state(model, weights, opt), mesh)
        step = make_sharded_train_step(model, state.optimizer, IMG_LAMBDA,
                                       0.0, mesh)
        state, m = step(state, shard_batch(batch, mesh))
        out[f"{case}.loss"] = np.float32(m["total"])
        out[f"{case}.overflow"] = np.float32(m["overflow"])
        _record(out, case, model)

    # The two-process step of tests/test_multihost.py: each rank loads its
    # stride of a shuffled global order and keeps it; two steps.
    gm = global_mesh()
    n = gm.shape["data"]
    order = np.random.default_rng(0).permutation(2 * n)
    mine = process_local_indices(order, 2 * n)
    all_frames = frames("3d", 2 * n)
    local = assemble_global_batch(
        {k: v[mine] for k, v in all_frames.items()}, gm)
    model = _model("3d", "kernel")
    state = replicate_state(_state(model, weights, "adam"), gm)
    step = make_sharded_train_step(model, state.optimizer, IMG_LAMBDA, 0.0, gm)
    for _ in range(2):
        state, m = step(state, local)
    out["multihost.loss"] = np.float32(m["total"])
    out["multihost.mine"] = mine


def task_tile(d, rank, out):
    """rasterize_tile_sharded and the strip-halo SSIM over one ``tile``
    axis of every rank."""
    from pose_splatter_torch.parallel import make_mesh
    from pose_splatter_torch.parallel.tile_sharding import (
        _ssim_band_partial,
        rasterize_tile_sharded,
    )

    mesh = make_mesh(axis_names=("tile",))
    with np.load(os.path.join(d, "tile_inputs.npz")) as z:
        inp = {k: torch.as_tensor(z[k]) for k in z.files}
    g = (inp["means"], inp["quats"], inp["scales"], inp["opac"], inp["colors"])
    for comp in ("tiled", "kernel"):
        rgb, alpha = rasterize_tile_sharded(
            *g, inp["views"], inp["Ks"], 64, 72, mesh, tile_shape=(8, 64),
            tile_capacity=64, backgrounds=torch.ones(3), compositor=comp)
        out[f"{comp}.rgb"], out[f"{comp}.alpha"] = rgb.numpy(), alpha.numpy()
        opac = inp["g_opac"].clone().requires_grad_()
        rgb, _ = rasterize_tile_sharded(
            inp["g_means"], inp["g_quats"], inp["g_scales"], opac,
            inp["g_colors"], inp["g_view"], inp["g_K"], 64, 64, mesh,
            tile_shape=(8, 64), tile_capacity=32, compositor=comp)
        (rgb ** 2).sum().backward()
        out[f"{comp}.grad"] = opac.grad.numpy()

    n = mesh.shape["tile"]
    th, tw = (2, 16)
    H, W = inp["ssim_pred"].shape[1:3]
    n_tx = -(-W // tw)
    pred, tgt = (strip_tiles(inp[k].numpy(), (th, tw), n)
                 for k in ("ssim_pred", "ssim_tgt"))
    T_l = pred.shape[1] // n
    i = mesh.index("tile")
    s, c = _ssim_band_partial(
        *(torch.as_tensor(x[:, i * T_l:(i + 1) * T_l]) for x in (pred, tgt)),
        mesh, "tile", n_tx, th, tw, H, W)
    out["ssim.sum"], out["ssim.count"] = s.numpy(), c.numpy()


def task_tile_step(d, rank, out):
    """make_tile_sharded_train_step on a (2, n/2) (data, tile) mesh."""
    from pose_splatter_torch.parallel import make_mesh, shard_batch
    from pose_splatter_torch.parallel.tile_sharding import (
        make_tile_sharded_train_step,
    )

    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    n = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh((2, n // 2), ("data", "tile"))
    for case, spec in cases.items():
        mode = spec["mode"]
        weights = _load(os.path.join(d, f"weights{mode}.npz"))
        with np.load(os.path.join(d, f"batch{mode}.npz")) as z:
            batch = {k: z[k] for k in z.files}
        model = _model(mode, "tiled")
        state = _state(model, weights, "sgd")
        before = {k: v.clone() for k, v in model.net.named_buffers()}
        step = make_tile_sharded_train_step(
            model, state.optimizer, IMG_LAMBDA, spec["ssim_lambda"], mesh,
            tile_shape=tuple(spec["tile_shape"]),
            tile_capacity=spec["capacity"], compositor=spec["compositor"])
        state, loss = step(state, shard_batch(batch, mesh, "data"))
        out[f"{case}.loss"] = loss.numpy()
        out[f"{case}.overflow"] = step.overflow.numpy()
        out[f"{case}.buffers_same"] = np.asarray(all(
            torch.equal(v, before[k]) for k, v in model.net.named_buffers()))
        _record(out, case, model)


def main():
    from pose_splatter_torch.parallel import initialize_distributed

    task, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank = torch.distributed.get_rank()
    out = {}
    {"dp": task_dp, "tile": task_tile, "tile_step": task_tile_step}[task](
        d, rank, out)
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
