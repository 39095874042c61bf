"""The port's 2D view-anchored train forward and train step against the JAX
package's, at a small size: 5 cameras of 64×48, grid 32, crop 16³, up to
256 Gaussians, 2 U-Nets of width 4.

Both sides start from the same weights (seeded numpy values moved through
the bridge) and see the same synthetic frames. The JAX side renders through
its Pallas kernels in interpret mode and trains with ``make_train_step`` +
``optax.adam``; the port through the compositors' plain versions (CPU
tensors) and ``torch.optim.Adam``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.models.pose_splatter import take_rows_unique as jtake
from pose_splatter_tpu.train.loop import TrainState as JState
from pose_splatter_tpu.train.loop import make_train_step as jmake_train_step
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatter as TModel
from pose_splatter_torch.models.pose_splatter import take_rows_unique
from pose_splatter_torch.train.loop import create_train_state, make_train_step
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

C, H, W = 5, 48, 64
LR = 1e-3
STEPS = 3
KW = dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
          volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="2d", gaussian_config={"view_anchored": True},
          holdout_views=[1], volume_fill_color=0.38)


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

    return jm, variables, torch_model, frames


def _batch(tm, frames, views):
    obs = tm.observed_views
    return dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                p_3d=frames["p_3d"], angle=frames["angle"],
                view_idx=np.array([obs[v] for v in views], np.int32),
                obs_idx=np.array(views, np.int32))


def test_train_forward_matches_jax(setup):
    """Train mode: BN on batch statistics, new running statistics returned
    (not written), the overflow counted."""
    jm, variables, torch_model, frames = setup
    tm = torch_model()
    obs = tm.observed_views
    mask, img = frames["mask"][0, obs], frames["img"][0, obs]
    p_3d, angle = frames["p_3d"][0], frames["angle"][0]
    with pltpu.force_tpu_interpret_mode():
        ref = jm.forward(jax.tree.map(jnp.asarray, variables), jnp.asarray(mask),
                         jnp.asarray(img), jnp.asarray(p_3d), jnp.float32(angle),
                         jnp.asarray([obs[2]]), train=True,
                         mutable=["batch_stats"], return_overflow=True)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    rgb, alpha, new_stats, overflow = tm(mask, img, p_3d, angle, [obs[2]],
                                         train=True)
    assert rgb.requires_grad and rgb.shape == (1, H, W, 3)
    # As the eval forward (test_torch_eval_slice), with BN on batch
    # statistics dividing by each channel's batch std.
    np.testing.assert_allclose(np.asarray(ref[0]), rgb.detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref[1]), alpha.detach().numpy(), atol=1e-4)
    assert int(ref[3]) == int(overflow)
    assert float(alpha.max()) > 0.5
    ref_sd = variables_from_flax({"params": variables["params"],
                                  "batch_stats": _np(ref[2]["batch_stats"])})
    assert sorted(new_stats) == sorted(
        k for k in ref_sd if k.endswith(("running_mean", "running_var")))
    for k, v in new_stats.items():
        # Batch means and variances of conv outputs summed in another order.
        np.testing.assert_allclose(ref_sd[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k, v in tm.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_take_rows_unique_gets_unique_indices(setup):
    """Trap: the indexing backward adds rows up, the JAX adjoint sets them;
    the two agree only for unique indices, which top-k gives."""
    _, _, torch_model, frames = setup
    tm = torch_model()
    obs = tm.observed_views
    vol = tm.carve(frames["mask"][0, obs], frames["img"][0, obs],
                   frames["p_3d"][0], frames["angle"][0])
    flat = tm.net.process_volume(vol.permute(1, 2, 3, 0)[None])
    from pose_splatter_torch.models.pose_splatter import select_gaussians
    sel = select_gaussians(flat[0], tm.min_n, tm.max_n, tm.prob_threshold,
                           tm.mask_threshold, tm.mask_threshold_delta)
    assert sel.indices.unique().numel() == sel.indices.numel() == tm.max_n
    rng = np.random.default_rng(1)
    x = rng.normal(size=(flat.shape[1], 8)).astype(np.float32)
    g = rng.normal(size=(tm.max_n, 8)).astype(np.float32)
    idx = sel.indices.numpy()
    _, vjp = jax.vjp(lambda v: jtake(v, jnp.asarray(idx), x.shape[0]),
                     jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    take_rows_unique(xt, sel.indices).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]),
                                  xt.grad.numpy())


@pytest.fixture(scope="module")
def trained(setup):
    """STEPS train steps, batch 2, on both sides from one bridged init."""
    jm, variables, torch_model, frames = setup
    tm = torch_model()
    batch = _batch(tm, frames, views=[0, 2])
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=tx.init(params))
    jstep = jmake_train_step(jm, tx, 0.5, 0.1, batch_size=2, donate=False)
    state = create_train_state(tm, LR)
    step = make_train_step(tm, state.optimizer, 0.5, 0.1, batch_size=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    init = {k: v.clone() for k, v in tm.net.state_dict().items()}
    out = dict(j=[], t=[], init=init)
    for i in range(STEPS):
        with pltpu.force_tpu_interpret_mode():
            jstate, jm_ = jstep(jstate, jbatch)
        state, m = step(state, batch)
        rec = dict(j_metrics=_np(jm_), t_metrics={k: float(v) for k, v in m.items()},
                   j_sd=variables_from_flax({"params": _np(jstate.params),
                                             "batch_stats": _np(jstate.batch_stats)}),
                   t_sd={k: v.clone() for k, v in tm.net.state_dict().items()})
        if i == 0:
            # Adam's first moment after one step is (1 − 0.9)·gradient.
            mu = jstate.opt_state[0].mu
            rec["j_mu"] = variables_from_flax({"params": _np(mu),
                                               "batch_stats": variables["batch_stats"]})
            rec["t_mu"] = {k: state.optimizer.state[p]["exp_avg"].clone()
                           for k, p in tm.net.named_parameters()
                           if p in state.optimizer.state}
        out["j"].append(rec)
    out["state"] = state
    return out


def test_train_step_gradients_match_jax(trained):
    """The first step's gradients, read from Adam's first moment (0.1·g on
    both sides), at a tight tolerance."""
    rec = trained["j"][0]
    t_mu, j_mu = rec["t_mu"], rec["j_mu"]
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
            # Conv bias before a train-mode BN: the true gradient is 0 and
            # both sides hold rounding noise (test_torch_train_unet).
            wg = np.abs(j_mu[k[:-5] + ".weight"].numpy()).max()
            assert np.abs(ref).max() <= 1e-3 * wg and np.abs(got).max() <= 1e-3 * wg, k
            continue
        scale = np.abs(ref).max()
        # Through the renderer, the head and 2 U-Nets, summed in another
        # order: within 1e-3 of each tensor's largest entry.
        np.testing.assert_allclose(ref, got, rtol=0, atol=1e-3 * scale + 1e-12,
                                   err_msg=k)
    assert np.abs(t_mu["head2.weight"].numpy()).max() > 0


def test_train_step_losses_and_stats_match_jax(trained):
    for i, rec in enumerate(trained["j"]):
        jmet, tmet = rec["j_metrics"], rec["t_metrics"]
        np.testing.assert_allclose(float(jmet["total"]), tmet["total"],
                                   rtol=1e-4, err_msg=f"step {i}")
        assert float(jmet["overflow"]) == tmet["overflow"]
        # The terms, each within 1e-5 of the total's scale (about 1.7): the
        # small SSIM term (0.03) drifts by a few 1e-6 by the third step.
        for k in ("iou", "ssim", "img"):
            np.testing.assert_allclose(float(jmet[k]), tmet[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        # Running statistics: the mean over the 2 frames of each frame's
        # update from the same old statistics. A conv bias before a BN may
        # move 2·lr further apart each step (its gradient is noise, see
        # below). That shifts the channel's batch mean by the gap, and the
        # running mean by 0.1 of it a step, and leaves the output and the
        # variance alone: at step i at most 0.1·2·lr·(1 + ... + i).
        for k, ref in rec["j_sd"].items():
            if k.endswith("running_mean"):
                atol = 1e-5 + 0.1 * LR * i * (i + 1)
            elif k.endswith("running_var"):
                atol = 1e-5
            else:
                continue
            np.testing.assert_allclose(ref.numpy(), rec["t_sd"][k].numpy(),
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"step {i} {k}")


def test_train_step_params_after_one_step(trained):
    """Adam's first step moves each parameter by about lr·sign(g): where g
    is rounding noise around 0 (conv biases before a BN) the sign can flip
    between the two sides, so parameters agree within 2·lr."""
    rec = trained["j"][0]
    moved = 0
    for k, ref in rec["j_sd"].items():
        if k.endswith(("running_mean", "running_var")):
            continue
        got = rec["t_sd"][k]
        np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=0,
                                   atol=2 * LR * (1 + 1e-4), err_msg=k)
        moved += int((got != trained["init"][k]).sum())
    assert moved > 0


def test_intermediate_unets_frozen_statistics_updated(trained):
    """The intermediate U-Net's body reaches no output: its parameters stay
    as they were, its BN statistics follow the batches."""
    init = trained["init"]
    for rec in trained["j"]:
        for k, v in rec["t_sd"].items():
            if not k.startswith("unets.0."):
                continue
            if k.endswith(("running_mean", "running_var")):
                assert not torch.equal(v, init[k]), k
            else:
                assert torch.equal(v, init[k]), k
    assert trained["state"].step == STEPS
