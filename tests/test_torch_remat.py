"""``remat_unets`` in the port: each U-Net under ``torch.utils.checkpoint``,
on the CPU at a small size (the 2D view-anchored setup of
``test_torch_train_slice.py``: 5 cameras of 64×48, grid 32, crop 16³, up
to 256 Gaussians, 2 U-Nets of width 4).

- With and without remat, one train forward and backward give the same
  gradients and the same new running statistics, bit for bit: the
  recomputation repeats the same float32 operations in the same order.
  The statistics are taken once, from the first forward.
- A remat train step against the JAX package's remat train step
  (``nn.remat``, ``make_train_step`` + ``optax.adam``, Pallas in interpret
  mode), compared in ROADMAP C.11's order and tolerances.
- ``make_train_multi_step`` runs a remat model, and equals its single
  steps bit for bit.
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
from pose_splatter_tpu.train.loop import make_train_step as jmake_train_step
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.train.loop import (
    create_train_state,
    make_train_multi_step,
    make_train_step,
)
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames
from test_torch_train_slice import KW, C, H, W
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", remat_unets=True, **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(2.0), np.float32)
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=2, seed=0)

    def torch_model(remat):
        tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu",
                    remat_unets=remat, **KW)
        tm.net.load_state_dict(variables_from_flax(variables))
        return tm

    return jm, variables, torch_model, frames


def _batch(tm, frames, f=0, pos=2):
    obs = tm.observed_views
    return dict(mask=frames["mask"][f:f + 1, obs], img=frames["img"][f:f + 1, obs],
                p_3d=frames["p_3d"][f:f + 1], angle=frames["angle"][f:f + 1],
                view_idx=np.array([obs[pos]], np.int32),
                obs_idx=np.array([pos], np.int32))


def test_remat_gradients_and_stats_equal_without(setup):
    _, _, torch_model, frames = setup
    out = {}
    for remat in (False, True):
        tm = torch_model(remat)
        assert tm.net.remat is remat
        calls = []
        # A pre-hook: the recomputation stops once it has rebuilt what the
        # backward needs, before a forward hook would run.
        tm.net.final_unet.register_forward_pre_hook(lambda *a: calls.append(1))
        obs = tm.observed_views
        rgb, alpha, new_stats, overflow = tm(
            frames["mask"][0, obs], frames["img"][0, obs], frames["p_3d"][0],
            frames["angle"][0], obs[1], train=True)
        stats = {k: v.clone() for k, v in new_stats.items()}
        (rgb.square().mean() + alpha.mean()).backward()
        out[remat] = dict(
            grads={k: p.grad for k, p in tm.net.named_parameters()},
            stats=stats, after_backward=new_stats, calls=len(calls))
    plain, remat = out[False], out[True]
    assert plain["calls"] == 1 and remat["calls"] == 2  # recomputed once
    assert sorted(plain["grads"]) == sorted(remat["grads"])
    for k, g in plain["grads"].items():
        if g is None:  # the intermediate U-Net's body: no graph either way
            assert remat["grads"][k] is None, k
        else:
            assert torch.equal(g, remat["grads"][k]), k
    assert sorted(plain["stats"]) == sorted(remat["stats"]) and plain["stats"]
    for k, v in plain["stats"].items():
        assert torch.equal(v, remat["stats"][k]), k
        # The backward's recomputation did not write its own statistics.
        assert torch.equal(remat["after_backward"][k], remat["stats"][k]), k


def test_remat_train_step_matches_jax(setup):
    """Two train steps of the remat model on both sides: the first step's
    gradients (Adam's first moment) within 1e-3 of each tensor's largest,
    losses at rtol 1e-4, parameters within 2·lr after one step, running
    means within 1e-5 + 0.1·2·lr (ROADMAP C.11)."""
    jm, variables, torch_model, frames = setup
    tm = torch_model(True)
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=tx.init(params))
    jstep = jmake_train_step(jm, tx, 0.5, 0.1, batch_size=1, donate=False)
    state = create_train_state(tm, LR)
    step = make_train_step(tm, state.optimizer, 0.5, 0.1)
    for i, (f, pos) in enumerate([(0, 2), (1, 0)]):
        batch = _batch(tm, frames, f, pos)
        with pltpu.force_tpu_interpret_mode():
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, batch)
        np.testing.assert_allclose(float(jmet["total"]), float(met["total"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        j_sd = variables_from_flax({"params": _np(jstate.params),
                                    "batch_stats": _np(jstate.batch_stats)})
        t_sd = tm.net.state_dict()
        if i == 0:
            j_mu = variables_from_flax({"params": _np(jstate.opt_state[0].mu),
                                        "batch_stats": variables["batch_stats"]})
            t_mu = {k: state.optimizer.state[p]["exp_avg"]
                    for k, p in tm.net.named_parameters()
                    if p in state.optimizer.state}
            checked = 0
            for k, ref in j_mu.items():
                if k.endswith(("running_mean", "running_var")):
                    continue
                ref = ref.numpy()
                if k.startswith("unets.0."):
                    assert (ref == 0).all() and k not in t_mu, k
                    continue
                got = t_mu[k].numpy()
                if ".conv" in k and k.endswith(".bias"):
                    wg = np.abs(j_mu[k[:-5] + ".weight"].numpy()).max()
                    assert np.abs(ref).max() <= 1e-3 * wg, k
                    assert np.abs(got).max() <= 1e-3 * wg, k
                    continue
                np.testing.assert_allclose(ref, got, rtol=0,
                                           atol=1e-3 * np.abs(ref).max() + 1e-12,
                                           err_msg=k)
                checked += 1
            assert checked > 10
            for k, ref in j_sd.items():
                tol = 2 * LR * (1 + 1e-4)
                if k.endswith("running_mean"):
                    tol = 1e-5 + 0.1 * 2 * LR
                elif k.endswith("running_var"):
                    tol = 1e-5
                np.testing.assert_allclose(ref.numpy(), t_sd[k].numpy(), rtol=0,
                                           atol=tol, err_msg=k)


def test_multi_step_runs_remat(setup):
    """A K = 2 call on a remat model equals two single steps of its twin."""
    _, _, torch_model, frames = setup
    totals = []
    for multi in (True, False):
        tm = torch_model(True)
        state = create_train_state(tm, LR)
        obs = tm.observed_views
        idx = (np.array([0, 1], np.int32), np.array([obs[2], obs[0]], np.int32),
               np.array([2, 0], np.int32))
        if multi:
            stack = dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                         p_3d=frames["p_3d"], angle=frames["angle"])
            ms = make_train_multi_step(tm, state.optimizer, 0.5, 0.1, stack,
                                       steps_per_call=2)
            state, _ = ms(state, *idx)
            totals.append(ms.step_metrics["total"].tolist())
        else:
            step = make_train_step(tm, state.optimizer, 0.5, 0.1)
            run = []
            for f, pos in [(0, 2), (1, 0)]:
                state, m = step(state, _batch(tm, frames, f, pos))
                run.append(float(m["total"]))
            totals.append(run)
        totals.append({k: v.clone() for k, v in tm.net.state_dict().items()})
    (t_multi, sd_multi, t_single, sd_single) = totals
    assert t_multi == t_single and np.isfinite(t_multi).all()
    for k, v in sd_multi.items():
        assert torch.equal(v, sd_single[k]), k
