"""Checkpoints across the two packages, on the CPU at a small size (the 2D
view-anchored setup of ``test_torch_train_slice.py``).

- The inverse bridge ``variables_to_flax`` undoes ``variables_from_flax``
  bit for bit, both ways: on the JAX model's own variable tree (with and
  without ``remat_unets``, whose trees are the same; seeded values, as
  Flax's initialisers take tens of seconds to compile on the CPU) and on
  the port's own initial weights.
- JAX trains, writes an Orbax checkpoint with its ``save_checkpoint``,
  reads it with its ``load_checkpoint``; the tree goes into the port's
  checkpoint file (``train/checkpoint_convert.py``), the port loads it, and
  the port's next step agrees with the JAX package's next step.
- The reverse: the port trains, its checkpoint file is read as a JAX tree,
  JAX writes and reads it through Orbax, and the next steps agree.

The next steps start from the same weights and the same Adam state on
both sides (checked bit for bit); they are compared at the train step's
tolerances (ROADMAP C.11): the loss at rtol 1e-4, parameters within 2·lr,
running means within 1e-5 + 0.1·2·lr, running variances within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.train.loop import TrainState as JState
from pose_splatter_tpu.train.loop import load_checkpoint as jload
from pose_splatter_tpu.train.loop import make_train_step as jmake_train_step
from pose_splatter_tpu.train.loop import save_checkpoint as jsave
from pose_splatter_torch.bridge import variables_from_flax, variables_to_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train import checkpoint_convert as cc
from pose_splatter_torch.train.loop import (
    create_train_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames
from test_torch_train_slice import KW, C, H, W
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

LR = 1e-3
EXTRA = {"epoch": 2, "losses": [[0.5, 0.25, 0.125], [0.4, 0.2, 0.1]]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("remat", [False, True])
def test_inverse_bridge_round_trips_bit_equal(remat):
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="tiled", remat_unets=remat, **KW)
    variables = random_variables(jm.net, jnp.zeros((1, 16, 16, 16, 4)),
                                 seed=3, train=False)
    # nn.remat keeps the module names: one tree, one bridge for both.
    plain = JModel(Ks, Es, W, H, render_mode="tiled", **KW)
    assert (jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(
        jax.eval_shape(plain.init, jax.random.PRNGKey(0))))
    # Flax → torch → Flax.
    back = variables_to_flax(variables_from_flax(variables))
    _leaves_equal({"params": variables["params"],
                   "batch_stats": variables["batch_stats"]}, back)
    # torch → Flax → torch, on the port's own initial weights.
    tm = TModel(Ks, Es, W, H, device="cpu", remat_unets=remat, seed=5, **KW)
    sd = tm.net.state_dict()
    again = variables_from_flax(variables_to_flax(sd))
    assert sorted(again) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(v, again[k]), k
    # The converted weights load into the port's model.
    tm.net.load_state_dict(variables_from_flax(back))


@pytest.fixture(scope="module")
def setup():
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(2.0), np.float32)
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=2, seed=0)
    tx = optax.adam(LR)
    jstep = jmake_train_step(jm, tx, 0.5, 0.1, batch_size=1, donate=False)

    def torch_model(seed=0):
        return TModel(Ks, Es, W, H, render_mode="kernel", device="cpu",
                      seed=seed, **KW)

    def batch(i):
        obs = [v for v in range(C) if v not in KW["holdout_views"]]
        f, pos = [(0, 2), (1, 0), (0, 3)][i]
        return dict(mask=frames["mask"][f:f + 1, obs],
                    img=frames["img"][f:f + 1, obs],
                    p_3d=frames["p_3d"][f:f + 1], angle=frames["angle"][f:f + 1],
                    view_idx=np.array([obs[pos]], np.int32),
                    obs_idx=np.array([pos], np.int32))

    def jax_step(jstate, i):
        with pltpu.force_tpu_interpret_mode():
            return jstep(jstate, {k: jnp.asarray(v) for k, v in batch(i).items()})

    return variables, tx, torch_model, batch, jax_step


def _same_state(tree, state):
    """The port's state holds the tree's weights and Adam state exactly."""
    sd = variables_from_flax({"params": tree["params"],
                              "batch_stats": tree["batch_stats"]})
    for k, v in state.model.net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    adam = tree["opt_state"][0]
    mu = variables_from_flax({"params": adam.mu, "batch_stats": tree["batch_stats"]})
    with_state = 0
    for k, p in state.model.net.named_parameters():
        s = state.optimizer.state.get(p)
        if s is None:
            assert k.startswith("unets.") and not mu[k].any(), k
            continue
        assert torch.equal(s["exp_avg"], mu[k]), k
        assert float(s["step"]) == int(adam.count)
        with_state += 1
    assert with_state > 10 and int(tree["step"]) == state.step


def _next_steps_agree(jstate, jmet, state, met):
    np.testing.assert_allclose(float(jmet["total"]), float(met["total"]),
                               rtol=1e-4)
    j_sd = variables_from_flax({"params": _np(jstate.params),
                                "batch_stats": _np(jstate.batch_stats)})
    for k, v in state.model.net.state_dict().items():
        tol = 2 * LR * (1 + 1e-4)
        if k.endswith("running_mean"):
            tol = 1e-5 + 0.1 * 2 * LR
        elif k.endswith("running_var"):
            tol = 1e-5
        np.testing.assert_allclose(j_sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def test_jax_orbax_checkpoint_resumes_in_the_port(setup, tmp_path):
    variables, tx, torch_model, batch, jax_step = setup
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=tx.init(params))
    for i in range(2):
        jstate, _ = jax_step(jstate, i)
    jsave(str(tmp_path / "jax.ckpt"), jstate, extra=EXTRA)
    restored, extra = jload(str(tmp_path / "jax.ckpt"), jstate)
    assert extra == EXTRA and int(restored.step) == 2
    tree = _np(restored._asdict())

    state = create_train_state(torch_model(seed=1), LR)
    cc.save_jax_tree(str(tmp_path / "port.ckpt"), tree, state, extra)
    state, extra2 = load_checkpoint(str(tmp_path / "port.ckpt"), state)
    assert extra2 == EXTRA
    _same_state(tree, state)
    state, met = make_train_step(state.model, state.optimizer, 0.5, 0.1)(
        state, batch(2))
    jnext, jmet = jax_step(restored, 2)
    assert state.step == int(jnext.step) == 3
    _next_steps_agree(jnext, jmet, state, met)


def test_port_checkpoint_resumes_in_jax_through_orbax(setup, tmp_path):
    variables, tx, torch_model, batch, jax_step = setup
    tm = torch_model()
    tm.net.load_state_dict(variables_from_flax(variables))
    state = create_train_state(tm, LR)
    step = make_train_step(tm, state.optimizer, 0.5, 0.1)
    for i in range(2):
        state, _ = step(state, batch(i))
    save_checkpoint(str(tmp_path / "port.ckpt"), state, extra=EXTRA)
    tree, extra = cc.load_jax_tree(str(tmp_path / "port.ckpt"))
    assert extra == EXTRA
    _same_state(tree, state)
    # The round trip through the tree is bit-equal, Adam's state included
    # (a parameter without torch state stays without).
    again = cc.from_jax_tree(tree, state)
    ref = state.optimizer.state_dict()
    assert sorted(again["opt_state"]["state"]) == sorted(ref["state"])
    # The intermediate U-Net has no torch state; a layer that sees one
    # voxel (encoder5 at a 16³ crop) has state with zero moments.
    assert len(ref["state"]) < len(list(tm.net.parameters()))
    assert any(not s["exp_avg"].any() for s in ref["state"].values())
    for i, s in ref["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(again["opt_state"]["state"][i][k], s[k]), (i, k)
    _leaves_equal(tree, cc.to_jax_tree(again))

    adam, empty = tree["opt_state"]
    assert isinstance(empty, cc.EmptyState) and int(adam.count) == 2
    jstate = JState(
        step=jnp.asarray(tree["step"]),
        params=jax.tree.map(jnp.asarray, tree["params"]),
        batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
        opt_state=(optax.ScaleByAdamState(
            count=jnp.asarray(adam.count), mu=jax.tree.map(jnp.asarray, adam.mu),
            nu=jax.tree.map(jnp.asarray, adam.nu)), optax.EmptyState()))
    jsave(str(tmp_path / "jax.ckpt"), jstate, extra=extra)
    restored, extra2 = jload(str(tmp_path / "jax.ckpt"), jstate)
    assert extra2 == EXTRA
    _leaves_equal(jax.tree.map(np.asarray, jstate), _np(restored))
    state, met = step(state, batch(2))
    jnext, jmet = jax_step(restored, 2)
    assert state.step == int(jnext.step) == 3
    _next_steps_agree(jnext, jmet, state, met)
