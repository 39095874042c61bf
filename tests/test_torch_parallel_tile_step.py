"""The port's (data, tile) train step (``parallel/tile_sharding.py::
make_tile_sharded_train_step``) on a (2, 2) mesh of 4 gloo ranks, against
the JAX step on a (2, 2) sub-mesh of the virtual CPU mesh and against the
port's unsharded ``make_train_step``.

Two models, each through the port's ``"tiled"`` and ``"kernel"``
compositors: the 3D model of ``test_torch_model_3d.py`` with (8, 32)
tiles, and a view-anchored 2D model on a 64x40 image with (8, 64) tiles
(5 tile rows, padded to 6 over the 2 tile ranks). Batch 2 (one frame a
data rank), img_lambda 0.5, ssim_lambda 0.1, one SGD step of rate 1 from
seeded weights moved through the bridge.

Both JAX steps give exactly the unsharded gradient (psum over ``tile``,
whose transpose sums the cotangents, then pmean over both axes); a port
whose collectives autograd did not see would land n_tile away, which only
an SGD step shows. The JAX reference is its ``"xla"`` compositor for both
of the port's: the JAX package holds its ``"pallas"`` tile compositor to
``"xla"`` within 1e-5 (``test_sharding.py:260-287``), and here the port's
two compositors are held to each other.

The unsharded reference renders the 3D model in its ``"global"`` mode (as
``test_sharding.py:319-325``) and the 2D model in ``"tiled"`` mode at the
same tile shape and capacity: in 2D the tile shape is part of the image
(ROADMAP §B).

Kept from the JAX step (ROADMAP C.21): the losses count the pixels of
whole tiles, those outside the image too. When the tile rows do not
divide over the ``tile`` axis, the pad tiles composite the background
(white) against a zero target, and the masked L1 counts it: 3·th·tw per
pad tile and frame, over the frame's mask sum. The 2D loss is held to the
unsharded loss plus that term.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import torch_parallel_worker as TW
from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.parallel.tile_sharding import (
    make_tile_sharded_train_step as jtile_step,
)
from pose_splatter_tpu.train.loop import TrainState as JState
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.parallel.launch import launch
from pose_splatter_torch.train.loop import make_train_step
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

RANKS = 4
B = 2
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
# 3D: a capacity of max_n, so that no tile drops a Gaussian and the
# "global" reference composites the same pairs; 2D: 64, so that the
# overflow counts (equal to the unsharded tiled step's) are not zero.
SPEC = {"3d": dict(tile_shape=[8, 32], capacity=512, ssim_lambda=0.1),
        "2d": dict(tile_shape=[8, 64], capacity=64, ssim_lambda=0.1)}
PAD_TILES = {"3d": 0, "2d": 1}  # 4 tile rows over 2 ranks; 5 padded to 6
CASES = {f"{m}-{c}": dict(SPEC[m], mode=m, compositor=c)
         for m in ("3d", "2d") for c in ("tiled", "kernel")}
STATS = ("running_mean", "running_var")


def _jmodel(mode, **kw):
    Ks, Es = TW.cameras(mode)
    H, W = TW.SIZE3 if mode == "3d" else TW.SIZE2
    return JModel(Ks, Es, W, H, **(TW.KW3 if mode == "3d" else TW.KW2), **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tile_step")
    with open(d / "cases.json", "w") as f:
        json.dump(CASES, f)
    weights, batches, jms = {}, {}, {}
    for mode in ("3d", "2d"):
        jm = _jmodel(mode)
        variables = random_variables(
            jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
        variables["params"]["scale"] = np.full((1,), TW.SCALE[mode],
                                               np.float32)
        weights[mode] = {k: v.numpy()
                         for k, v in variables_from_flax(variables).items()}
        batches[mode] = TW.frames(mode, B)
        jms[mode] = (jm, variables)
        np.savez(d / f"weights{mode}.npz", **weights[mode])
        np.savez(d / f"batch{mode}.npz", **batches[mode])

    with ThreadPoolExecutor(1) as ex:
        ranks_done = ex.submit(launch, RANKS, [WORKER, "tile_step", str(d)],
                               timeout=300)
        mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(2, 2),
                    ("data", "tile"))
        tx = optax.sgd(1.0)
        jax_out = {}
        for mode in ("3d", "2d"):
            jm, variables = jms[mode]
            params = jax.tree.map(jnp.asarray, variables["params"])
            state = JState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params))
            step = jtile_step(jm, tx, TW.IMG_LAMBDA, SPEC[mode]["ssim_lambda"],
                              mesh, tile_shape=tuple(SPEC[mode]["tile_shape"]),
                              tile_capacity=SPEC[mode]["capacity"],
                              compositor="xla")
            new, loss = step(state, {k: jnp.asarray(v)
                                     for k, v in batches[mode].items()})
            jax_out[mode] = (float(loss), {k: v.numpy() for k, v in
                                           variables_from_flax({
                                               "params": jax.tree.map(
                                                   np.asarray, new.params),
                                               "batch_stats": variables[
                                                   "batch_stats"]}).items()})
        port_out = {}
        for mode in ("3d", "2d"):
            kw = {} if mode == "3d" else dict(
                tile_shape=tuple(SPEC[mode]["tile_shape"]),
                tile_capacity=SPEC[mode]["capacity"])
            model = TW._model(mode, "global" if mode == "3d" else "tiled", **kw)
            state = TW._state(model, {k: torch.as_tensor(v) for k, v in
                                      weights[mode].items()}, "sgd")
            _, m = make_train_step(model, state.optimizer, TW.IMG_LAMBDA,
                                   SPEC[mode]["ssim_lambda"],
                                   batch_size=B)(state, batches[mode])
            b = batches[mode]
            msum = np.maximum(b["mask"][np.arange(B), b["obs_idx"]]
                              .sum(axis=(1, 2)), 1.0)
            th, tw = SPEC[mode]["tile_shape"]
            pad_l1 = TW.IMG_LAMBDA * np.mean(3 * th * tw * PAD_TILES[mode]
                                             / msum)
            port_out[mode] = (float(m["total"]), float(m["overflow"]),
                              float(pad_l1))
        ranks_done.result()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(weights=weights, jax=jax_out, port=port_out, ranks=ranks)


def _case(rank, case):
    return {k[len(case) + 1:]: v for k, v in rank.items()
            if k.startswith(case + ".")}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_step_loss(run, case):
    """The loss is the same on every rank, within 2e-3 of the unsharded
    step's (``test_sharding.py:321-325``; in 2D plus the pad tiles' L1 of
    C.21) and within 1e-4 of the JAX step's; the running statistics are
    as they were."""
    mode = CASES[case]["mode"]
    losses = [float(r[f"{case}.loss"]) for r in run["ranks"]]
    assert np.isfinite(losses[0])
    assert all(x == losses[0] for x in losses)
    unsharded, _, pad_l1 = run["port"][mode]
    assert (pad_l1 > 0) == (mode == "2d")
    assert losses[0] == pytest.approx(unsharded + pad_l1, rel=2e-3)
    assert losses[0] == pytest.approx(run["jax"][mode][0], rel=1e-4)
    assert all(bool(r[f"{case}.buffers_same"]) for r in run["ranks"])


@pytest.mark.parametrize("case", list(CASES))
def test_tile_step_sgd_update_matches_jax(run, case):
    """After one SGD step of rate 1 every rank holds the same parameters,
    and the update (the gradient) matches JAX's: its projection on JAX's
    is 1 within 1e-3 (an n_tile factor gives 2 or 1/2), and each tensor is
    within 1e-3 of its largest entry plus 1e-6 of the largest update
    (``test_torch_parallel_dp.py``'s tolerance), the conv biases before a
    BN held as rounding noise (ROADMAP C.11)."""
    mode = CASES[case]["mode"]
    w0 = {k: v for k, v in run["weights"][mode].items()
          if not k.endswith(STATS)}
    r0 = _case(run["ranks"][0], case)
    for r in run["ranks"][1:]:
        rk = _case(r, case)
        for k in w0:
            np.testing.assert_array_equal(rk[k], r0[k], err_msg=k)
    got = {k: r0[k] - w0[k] for k in w0}
    ref = {k: run["jax"][mode][1][k] - w0[k] for k in w0}
    top = max(np.abs(v).max() for v in ref.values())
    assert top > 0
    dot = sum(float((got[k] * ref[k]).sum()) for k in w0)
    norm = sum(float((ref[k] ** 2).sum()) for k in w0)
    assert dot / norm == pytest.approx(1.0, abs=1e-3)
    for k, j in ref.items():
        if ".conv" in k and k.endswith(".bias"):
            wg = np.abs(ref[k[:-5] + ".weight"]).max()
            assert np.abs(j).max() <= 1e-3 * wg, k
            assert np.abs(got[k]).max() <= 1e-3 * wg, k
            continue
        np.testing.assert_allclose(got[k], j, rtol=0,
                                   atol=1e-3 * np.abs(j).max() + 1e-6 * top,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_tile_step_compositors_agree(run, mode):
    """The two compositors give the same step: losses within 1e-6
    relative, updates within 1e-5 of the largest; the overflow equals the
    unsharded tiled step's in 2D."""
    a, b = (_case(run["ranks"][0], f"{mode}-{c}") for c in ("tiled", "kernel"))
    assert float(a["loss"]) == pytest.approx(float(b["loss"]), rel=1e-6)
    w0 = run["weights"][mode]
    top = max(np.abs(a[k] - w0[k]).max() for k in w0)
    for k in w0:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * top,
                                   err_msg=k)
    assert float(a["overflow"]) == float(b["overflow"])
    if mode == "2d":
        assert float(a["overflow"]) == run["port"][mode][1]
