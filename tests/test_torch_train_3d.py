"""Three 3D train steps of batch 2 of the port against the JAX package's
``make_train_step`` + ``optax.adam``, at a small size (the setup of
``test_torch_model_3d.py``: 3 cameras of 32×32, grid 16, up to 128
Gaussians, 2 U-Nets of width 4).

Both sides start from the same weights (seeded numpy values moved through
the bridge) and see the same synthetic frames. The JAX side renders
through its Pallas kernels in interpret mode, the port through the
compositors' plain versions (CPU tensors), both in conic mode.

The two sides are not bit-equal upstream of the compositor (XLA's jitted
CPU code fuses multiply-adds that PyTorch rounds apart; in train mode the
BN batch statistics carry the U-Net's rounding, about 6e-5 of the
volume). A pixel-Gaussian pair within that rounding of a compositing gate
(the 1/255 skip, the 0.999 clamp, T·(1 − a) >= 1e-4) takes the other
branch on the other side: a step in the image and in the gradient, not a
rounding error. The seeded scene holds no such pair; the tolerances are
the 2D train slice's (``test_torch_train_slice.py``).
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
from pose_splatter_torch.train.loop import create_train_state, make_train_step
from pose_splatter_torch.utils.synthetic import ring_cameras
from test_torch_model_3d import KW, C, H, W, _frames
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    """STEPS train steps, batch 2, on both sides from one bridged init."""
    Ks, Es = ring_cameras(C, W, H, focal=60.0, radius=0.6)
    jm = JModel(Ks, Es, W, H, render_mode="pallas", **KW)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), np.log(0.03), np.float32)
    tm = TModel(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    tm.net.load_state_dict(variables_from_flax(variables))
    frames = _frames(Ks, Es, 2)
    obs = tm.observed_views
    batch = dict(mask=frames["mask"][:, obs], img=frames["img"][:, obs],
                 p_3d=frames["p_3d"], angle=frames["angle"],
                 view_idx=np.array([obs[0], obs[1]], np.int32),
                 obs_idx=np.array([0, 1], np.int32))
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=tx.init(params))
    jstep = jmake_train_step(jm, tx, 0.5, 0.0, batch_size=2, donate=False)
    state = create_train_state(tm, LR)
    step = make_train_step(tm, state.optimizer, 0.5, 0.0, batch_size=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
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
            rec["j_mu"] = variables_from_flax(
                {"params": _np(jstate.opt_state[0].mu),
                 "batch_stats": variables["batch_stats"]})
            rec["t_mu"] = {k: state.optimizer.state[p]["exp_avg"].clone()
                           for k, p in tm.net.named_parameters()
                           if p in state.optimizer.state}
        out.append(rec)
    return out


def test_3d_train_step_gradients_match_jax(trained):
    """The first step's gradients, read from Adam's first moment (0.1·g on
    both sides): through projection, depth sort, both compositors in conic
    mode, the 14-wide head and the final U-Net."""
    t_mu, j_mu = trained[0]["t_mu"], trained[0]["j_mu"]
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
            # Conv bias before a train-mode BN: the true gradient is 0 and
            # both sides hold rounding noise (test_torch_train_unet).
            wg = np.abs(j_mu[k[:-5] + ".weight"].numpy()).max()
            assert np.abs(ref).max() <= 1e-3 * wg and np.abs(got).max() <= 1e-3 * wg, k
            continue
        # Summed in another order: within 1e-3 of each tensor's largest entry.
        np.testing.assert_allclose(ref, got, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-12,
                                   err_msg=k)
        checked += 1
    assert checked > 10
    assert np.abs(t_mu["head2.weight"].numpy()).max() > 0
    # Every one of the 14 head outputs but the unused opacity slot (7)
    # reaches the loss.
    rows = np.abs(t_mu["head2.weight"].numpy()).max(axis=1)
    assert (rows[np.arange(14) != 7] > 0).all() and rows[7] == 0


def test_3d_train_step_losses_match_jax(trained):
    for i, rec in enumerate(trained):
        jmet, tmet = rec["j_metrics"], rec["t_metrics"]
        np.testing.assert_allclose(float(jmet["total"]), tmet["total"],
                                   rtol=1e-4, err_msg=f"step {i}")
        assert float(jmet["overflow"]) == tmet["overflow"]
        for k in ("iou", "img"):
            np.testing.assert_allclose(float(jmet[k]), tmet[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {i} {k}")


def test_3d_train_step_params_after_one_step(trained):
    """Adam's first step moves each parameter by about lr·sign(g): where g
    is rounding noise around 0 (conv biases before a BN) the sign can flip
    between the two sides, so parameters agree within 2·lr."""
    rec = trained[0]
    for k, ref in rec["j_sd"].items():
        if k.endswith(("running_mean", "running_var")):
            continue
        np.testing.assert_allclose(ref.numpy(), rec["t_sd"][k].numpy(), rtol=0,
                                   atol=2 * LR * (1 + 1e-4), err_msg=k)
