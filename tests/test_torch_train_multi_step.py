"""K train steps a call (``make_train_multi_step``) and the selection's
device route, on the CPU at a small size (the 2D view-anchored setup of
``test_torch_train_slice.py``: 5 cameras of 64×48, grid 32, crop 16³, up
to 256 Gaussians, 2 U-Nets of width 4).

- The port's K-step call equals K calls of its own ``make_train_step``
  exactly: losses, parameters, statistics and Adam's state.
- Against the JAX package's ``make_train_multi_step`` + ``optax.adam``
  (Pallas in interpret mode), compared in ROADMAP C.11's order: gradients
  (read from Adam's first moment), then parameters, then running means,
  with each step's loss and the metrics of the last step.
- ``select_gaussians``' device route (the threshold table, no read-back)
  against the JAX loops, bit for bit, on hand-made and drawn ``vol0``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.models.pose_splatter import select_gaussians as jselect
from pose_splatter_tpu.train.loop import TrainState as JState
from pose_splatter_tpu.train.loop import make_train_multi_step as jmake_multi
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.models.pose_splatter import (
    TABLE_STEPS,
    select_gaussians,
    threshold_table,
)
from pose_splatter_torch.train.loop import (
    METRICS,
    create_train_state,
    make_train_multi_step,
    make_train_step,
)
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames
from test_torch_train_slice import KW, C, H, W
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

LR = 1e-3
K = 3
# Steps of the call: frame, observed-view position.
FRAME_IDX = [0, 1, 0]
OBS_POS = [2, 0, 3]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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

    def torch_model():
        tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
        tm.net.load_state_dict(variables_from_flax(variables))
        return tm

    obs = torch_model().observed_views
    stack = dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                 p_3d=frames["p_3d"], angle=frames["angle"])
    idx = (np.array(FRAME_IDX, np.int32),
           np.array([obs[p] for p in OBS_POS], np.int32),
           np.array(OBS_POS, np.int32))
    return jm, variables, torch_model, stack, idx


def test_multi_step_equals_single_steps(setup):
    """One call of K = 3 steps against three make_train_step calls from the
    same weights: the same computation, so equal bit for bit."""
    _, _, torch_model, stack, idx = setup
    runs = []
    for multi in (True, False):
        tm = torch_model()
        state = create_train_state(tm, LR)
        if multi:
            ms = make_train_multi_step(tm, state.optimizer, 0.5, 0.1, stack,
                                       steps_per_call=K)
            state, last = ms(state, *idx)
            totals = ms.step_metrics["total"].tolist()
            assert sorted(last) == sorted(METRICS)
            assert float(last["total"]) == totals[-1]
        else:
            step = make_train_step(tm, state.optimizer, 0.5, 0.1)
            totals = []
            for k in range(K):
                f = idx[0][k]
                batch = {n: v[f:f + 1] for n, v in stack.items()}
                batch.update(view_idx=idx[1][k:k + 1], obs_idx=idx[2][k:k + 1])
                state, m = step(state, batch)
                totals.append(float(m["total"]))
        assert state.step == K
        opt = state.optimizer.state_dict()["state"]
        runs.append((totals, {k: v.clone() for k, v in tm.net.state_dict().items()},
                     opt))
    (t_multi, sd_multi, opt_multi), (t_single, sd_single, opt_single) = runs
    assert t_multi == t_single
    assert len(set(t_multi)) == K  # three distinct steps
    for k, v in sd_multi.items():
        assert torch.equal(v, sd_single[k]), k
    for i, s in opt_multi.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], opt_single[i][k]), (i, k)


def test_multi_step_refuses_stage_recording(setup):
    _, _, torch_model, stack, idx = setup
    tm = torch_model()
    state = create_train_state(tm, LR)
    ms = make_train_multi_step(tm, state.optimizer, 0.5, 0.1, stack,
                               steps_per_call=K)
    with stages.record("cpu"):
        with pytest.raises(RuntimeError, match="record"):
            ms(state, *idx)
    with pytest.raises(ValueError, match="3 steps"):
        ms(state, *(x[:2] for x in idx))


@pytest.fixture(scope="module")
def against_jax(setup):
    """The JAX side: its make_train_multi_step at steps_per_call 1, called
    for each of the K steps (one compile), recorded after the first and
    the last. The port: its K = 1 call for the first step and, from the
    same weights, one K = 3 call."""
    jm, variables, torch_model, stack, idx = setup
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray,
                                             variables["batch_stats"]),
                    opt_state=tx.init(params))
    jms = jmake_multi(jm, tx, 0.5, 0.1, frames=stack, steps_per_call=1)
    j = []
    for k in range(K):
        with pltpu.force_tpu_interpret_mode():
            jstate, jmet = jms(jstate, *(jnp.asarray(x[k:k + 1]) for x in idx))
        j.append(dict(
            metrics=_np(jmet),
            sd=variables_from_flax({"params": _np(jstate.params),
                                    "batch_stats": _np(jstate.batch_stats)}),
            mu=variables_from_flax({"params": _np(jstate.opt_state[0].mu),
                                    "batch_stats": variables["batch_stats"]})))
    t = []
    for steps in (1, K):
        tm = torch_model()
        init = {k: v.clone() for k, v in tm.net.state_dict().items()}
        state = create_train_state(tm, LR)
        ms = make_train_multi_step(tm, state.optimizer, 0.5, 0.1, stack,
                                   steps_per_call=steps)
        state, met = ms(state, *(x[:steps] for x in idx))
        assert state.step == steps
        t.append(dict(
            metrics={k: float(v) for k, v in met.items()},
            totals=ms.step_metrics["total"].tolist(),
            sd={k: v.clone() for k, v in tm.net.state_dict().items()},
            mu={k: state.optimizer.state[p]["exp_avg"].clone()
                for k, p in tm.net.named_parameters()
                if p in state.optimizer.state}, init=init))
    return j, t


def test_multi_step_gradients_match_jax(against_jax):
    """The first step's gradients, read from Adam's first moment (0.1·g on
    both sides), within 1e-3 of each tensor's largest entry (the single
    step's tolerance, test_torch_train_slice)."""
    j, t = against_jax
    j_mu, t_mu = j[0]["mu"], t[0]["mu"]
    checked = 0
    for k, ref in j_mu.items():
        if k.endswith(("running_mean", "running_var")):
            continue
        ref = ref.numpy()
        if k.startswith("unets.0."):
            # The intermediate U-Net: gradient exactly 0 in JAX, None here.
            assert (ref == 0).all() and k not in t_mu, k
            continue
        got = t_mu[k].numpy()
        if ".conv" in k and k.endswith(".bias"):
            # Conv bias before a train-mode BN: rounding noise around 0.
            wg = np.abs(j_mu[k[:-5] + ".weight"].numpy()).max()
            assert np.abs(ref).max() <= 1e-3 * wg, k
            assert np.abs(got).max() <= 1e-3 * wg, k
            continue
        np.testing.assert_allclose(ref, got, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-12,
                                   err_msg=k)
        checked += 1
    assert checked > 10


@pytest.mark.parametrize("step", [0, K - 1])
def test_multi_step_params_match_jax(against_jax, step):
    """Adam moves a parameter by about lr a step; where its gradient is
    rounding noise around 0 the sign can differ between the sides, so they
    part by up to 2·lr a step: within 2·lr after the first step (C.11),
    2·lr·K after the K-step call. The parameters moved."""
    j, t = against_jax
    ref_sd, got = j[step]["sd"], t[0 if step == 0 else 1]
    moved = 0
    for k, ref in ref_sd.items():
        if k.endswith(("running_mean", "running_var")):
            continue
        np.testing.assert_allclose(ref.numpy(), got["sd"][k].numpy(), rtol=0,
                                   atol=2 * LR * (step + 1) * (1 + 1e-4),
                                   err_msg=k)
        moved += int((got["sd"][k] != got["init"][k]).sum())
    assert moved > 0


def test_multi_step_metrics_and_stats_match_jax(against_jax):
    """Each step's loss of the K-step call and the metrics of its last step
    (test_torch_train_slice's tolerances), then the running statistics:
    after the first step within 1e-5 (mean and variance); after the K-th,
    the means within 0.1·2·lr for each earlier step (a conv bias before a
    BN may part 2·lr a step and moves its channel's running mean by 0.1 of
    the gap a step). Later steps' variances carry the parameters' drift
    and are held through the losses."""
    j, t = against_jax
    np.testing.assert_allclose([float(r["metrics"]["total"]) for r in j],
                               t[1]["totals"], rtol=1e-4)
    jmet, tmet = j[-1]["metrics"], t[1]["metrics"]
    np.testing.assert_allclose(float(jmet["total"]), tmet["total"], rtol=1e-4)
    assert float(jmet["overflow"]) == tmet["overflow"]
    for k in ("iou", "ssim", "img"):
        np.testing.assert_allclose(float(jmet[k]), tmet[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for i, (ref_sd, got_sd) in ((0, (j[0]["sd"], t[0]["sd"])),
                                (K - 1, (j[-1]["sd"], t[1]["sd"]))):
        for k, ref in ref_sd.items():
            if k.endswith("running_mean"):
                atol = 1e-5 + 0.1 * LR * i * (i + 1)
            elif k.endswith("running_var") and i == 0:
                atol = 1e-5
            else:
                continue
            np.testing.assert_allclose(ref.numpy(), got_sd[k].numpy(),
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"step {i} {k}")


# ----------------------------------------------------------------------------
# select_gaussians: the device route against the JAX loops.
# ----------------------------------------------------------------------------

PT, MT, DELTA = 0.25, 0.25, 0.05
F32 = np.float32
LP = F32(math.log(PT / (1 - PT)))


def _path(vol0, min_n, max_n):
    """(up steps, down steps) of the JAX loops on vol0, counted in numpy."""
    mt, ups, downs = F32(MT), 0, 0
    while (vol0 > F32(mt + LP)).sum() > max_n:
        mt, ups = F32(mt + F32(DELTA)), ups + 1
    while (vol0 > F32(mt + LP)).sum() < min_n:
        mt, downs = F32(mt - F32(DELTA)), downs + 1
    return ups, downs


def _check(vol0, min_n, max_n, pt=PT, mt=MT, delta=DELTA):
    a = jselect(jnp.asarray(vol0), min_n, max_n, pt, mt, delta)
    for route in ("device", "host"):
        b = select_gaussians(torch.from_numpy(vol0), min_n, max_n, pt, mt,
                             delta, route=route)
        assert not bool(b.table_miss), route
        assert F32(a.mask_threshold) == b.mask_threshold.numpy(), route
        np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
        np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())


def _iterate_t(k):
    """t_k = f32(u_k + lp) of the up loop's k-th iterate."""
    u = F32(MT)
    for _ in range(k):
        u = F32(u + F32(DELTA))
    return F32(u + LP)


def _down_t(j):
    d = F32(MT)
    for _ in range(j):
        d = F32(d - F32(DELTA))
    return F32(d + LP)


def _hand_made(case):
    N = 256
    rng = np.random.default_rng(3)
    if case == "up":
        return np.linspace(-1, 6, N).astype(F32)[rng.permutation(N)], 20, 40
    if case == "down":
        return np.linspace(-8, -1, N).astype(F32)[rng.permutation(N)], 100, 200
    if case == "both_tie_at_cap":
        v = np.concatenate([np.full(150, 2.0), np.linspace(-5, 0, 106)])
        return v.astype(F32)[rng.permutation(N)], 50, 100
    if case == "v_hi_on_iterate":
        t = _iterate_t(37)
        v = np.concatenate([np.full(40, t + 1), [t], np.linspace(-3, t - 1, 215)])
        return v.astype(F32)[rng.permutation(N)], 30, 40
    if case == "v_lo_on_iterate":
        t = _down_t(12)
        v = np.concatenate([np.full(9, t + 0.3), [t], np.linspace(-9, t - 0.2, 246)])
        return v.astype(F32)[rng.permutation(N)], 10, 40
    if case == "max_n_is_n":
        return rng.choice([-3.0, 0.0, 2.0], N).astype(F32), 200, N
    raise ValueError(case)


@pytest.mark.parametrize("case,path", [
    ("up", "up"), ("down", "down"), ("both_tie_at_cap", "both"),
    ("v_hi_on_iterate", "up"), ("v_lo_on_iterate", "down"),
    ("max_n_is_n", "down")])
def test_device_selection_hand_made(case, path):
    vol0, min_n, max_n = _hand_made(case)
    ups, downs = _path(vol0, min_n, max_n)
    assert path == {(True, False): "up", (False, True): "down",
                    (True, True): "both"}[(ups > 0, downs > 0)]
    if case == "v_hi_on_iterate":
        assert ups == 37
    if case == "v_lo_on_iterate":
        assert downs == 13  # the loop goes on at equality
    _check(vol0, min_n, max_n)


_values = st.sampled_from([0.0, -0.0, 1.0, 2.0, 4.0, 0.25, -0.85, 1.3,
                           float(_iterate_t(7)), float(_down_t(5)),
                           float("nan")])


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_device_selection_drawn(data):
    """Ties, signed zeros, NaNs (skipped by the counts, first in top_k's
    order) and values on the loops' iterates, at random caps."""
    N = 64
    base = data.draw(st.lists(_values, min_size=N, max_size=N))
    noise = data.draw(st.lists(st.floats(-6, 6, width=32), min_size=N,
                               max_size=N))
    mix = data.draw(st.lists(st.booleans(), min_size=N, max_size=N))
    vol0 = np.where(mix, base, noise).astype(F32)
    n_nan = int(np.isnan(vol0).sum())
    min_n = data.draw(st.integers(1, N - n_nan))
    max_n = data.draw(st.integers(min_n, N))
    delta = data.draw(st.sampled_from([0.05, 0.013, 0.25]))
    _check(vol0, min_n, max_n, delta=delta)


def test_table_miss_sets_the_flag_and_the_model_raises(setup):
    """A value past the table is flagged, never clamped; the model raises
    at its check and clears the flag."""
    vol0 = np.zeros(64, F32)
    vol0[:10] = 1e6  # the up loop would run about 2e7 steps
    sel = select_gaussians(torch.from_numpy(vol0), 1, 5, PT, MT, DELTA,
                           route="device")
    assert bool(sel.table_miss)
    up_t = threshold_table(MT, DELTA, PT, "cpu")[0]
    assert up_t.numel() == TABLE_STEPS + 1 and float(up_t[-1]) < 1e6
    tm = setup[2]()
    vol = torch.zeros(tm.out_channels, 16 ** 3)
    vol[0, :300] = 1e6
    with torch.no_grad():
        tm.gaussians_from_volume(vol)
    with pytest.raises(RuntimeError, match="threshold table"):
        tm.check_selection()
    tm.check_selection()  # cleared
