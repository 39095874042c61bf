"""The port's data-parallel step (``parallel/sharding.py``) in 2 gloo
ranks of 2 frames each, against the JAX package's
``make_sharded_train_step`` on a 2-device sub-mesh of the virtual CPU
mesh, and against the port's own unsharded ``make_train_step``.

The model and frames are ``test_torch_model_3d.py``'s (3 cameras of
32x32, grid 16, 3D Gaussians; its seeded scene holds no pixel-Gaussian
pair on a conic gate), with seeded numpy weights moved through the bridge.
Both ``"global"`` and ``"kernel"`` render (the JAX ``"pallas"``; the
port's compositors' plain versions on the CPU). The JAX DP step cannot
carry interpret-mode Pallas (the SPMD partitioner refuses its callback,
``__graft_entry__.py:125-127``), so the kernel case is held against the
JAX unsharded step, which the DP step equals by construction.

Both JAX DP steps give exactly the unsharded gradient. A port that
averaged a sum, or missed a rank, would be off by a factor that Adam's
update hides; so the parameters are compared after one SGD step of rate 1
(the update is the gradient itself), and after one Adam step as
``tests/test_sharding.py:81-91`` does.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import torch_parallel_worker as TW
from pose_splatter_tpu.models.pose_splatter import PoseSplatter as JModel
from pose_splatter_tpu.parallel import make_sharded_train_step as jsharded
from pose_splatter_tpu.parallel import replicate_state as jreplicate
from pose_splatter_tpu.parallel import shard_batch as jshard
from pose_splatter_tpu.train.loop import TrainState as JState
from pose_splatter_tpu.train.loop import make_train_step as jmake_train_step
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.parallel.launch import launch
from pose_splatter_torch.train.loop import make_train_step
from test_torch_unet_bridge import random_variables

torch.set_num_threads(1)

RANKS = 2
B = 4  # 2 frames a rank
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
STATS = ("running_mean", "running_var")


def _sd(params, batch_stats):
    return {k: v.numpy() for k, v in variables_from_flax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, batch_stats)}).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    Ks, Es = TW.cameras("3d")
    H, W = TW.SIZE3
    jm = JModel(Ks, Es, W, H, render_mode="global", **TW.KW3)
    variables = random_variables(
        jm.net, jnp.zeros((1, 16, 16, 16, 4)), seed=0, train=False)
    variables["params"]["scale"] = np.full((1,), TW.SCALE["3d"], np.float32)
    weights = {k: v.numpy() for k, v in variables_from_flax(variables).items()}
    np.savez(d / "weights3d.npz", **weights)
    batch = TW.frames("3d", B)
    np.savez(d / "batch3d.npz", **batch)

    with ThreadPoolExecutor(1) as ex:
        ranks_done = ex.submit(launch, RANKS, [WORKER, "dp", str(d)],
                               timeout=300)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
        jax_out = {}
        for case, tx in (("global-sgd", optax.sgd(1.0)),
                         ("global-adam", optax.adam(TW.LR_ADAM))):
            state = JState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params))
            step = jsharded(jm, tx, TW.IMG_LAMBDA, 0.0, mesh)
            new, m = step(jreplicate(state, mesh), jshard(jbatch, mesh))
            jax_out[case] = (float(m["total"]), float(m["overflow"]),
                             _sd(new.params, new.batch_stats))
        jp = JModel(Ks, Es, W, H, render_mode="pallas", **TW.KW3)
        tx = optax.sgd(1.0)
        state = JState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
        with pltpu.force_tpu_interpret_mode():
            new, m = jmake_train_step(jp, tx, TW.IMG_LAMBDA, 0.0,
                                      batch_size=B, donate=False)(state, jbatch)
        jax_out["kernel-sgd"] = (float(m["total"]), float(m["overflow"]),
                                 _sd(new.params, new.batch_stats))
        # The port unsharded, on the whole batch.
        port_out = {}
        for case in ("global-sgd", "global-adam", "kernel-sgd"):
            render, opt = case.split("-")
            model = TW._model("3d", render)
            state = TW._state(model, {k: torch.as_tensor(v)
                                      for k, v in weights.items()}, opt)
            _, m = make_train_step(model, state.optimizer, TW.IMG_LAMBDA, 0.0,
                                   batch_size=B)(state, batch)
            port_out[case] = (float(m["total"]), {
                k: v.numpy() for k, v in model.net.state_dict().items()})
        ranks_done.result()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(weights=weights, jax=jax_out, port=port_out, ranks=ranks)


def _params(sd):
    return {k: v for k, v in sd.items() if not k.endswith(STATS)}


@pytest.mark.parametrize("case", ["global-sgd", "global-adam", "kernel-sgd"])
def test_dp_loss_matches_jax(run, case):
    """The metrics' ``total`` is the global batch's mean, the same on every
    rank, within 1e-4 of the JAX step's (``__graft_entry__.py:117``); the
    overflow count equal."""
    losses = [float(r[f"{case}.loss"]) for r in run["ranks"]]
    assert losses[0] == losses[1]
    jloss, joverflow, _ = run["jax"][case]
    np.testing.assert_allclose(losses[0], jloss, rtol=1e-4)
    assert float(run["ranks"][0][f"{case}.overflow"]) == joverflow


# The final U-Net's first block: frame 1 holds one voxel of its output
# within float32 rounding of the LeakyReLU's kink (JAX +4.98e-5, the port
# -9.2e-7), so the packages take slopes 1 and 0.1 there and this block's
# gradient differs by up to 12 % of its update (ROADMAP C.20).
KINK = "final_unet.encoder1."


def _update(sd, w0):
    return {k: sd[k] - w0[k] for k in w0}


@pytest.mark.parametrize("case", ["global-sgd", "kernel-sgd"])
def test_dp_sgd_update_matches_jax(run, case):
    """After one SGD step of rate 1 the parameters moved by exactly the
    gradient. Every rank holds the same parameters; they are within 1e-5
    of the update's largest entry of the port's unsharded step's (the
    check a missing or doubled factor fails); outside the block of C.20
    the update's projection on JAX's DP update is 1 within 1e-3, and each
    tensor is within 1e-3 of
    its largest entry of JAX's, the packages' gradient tolerance
    (``test_torch_train_3d.py``; plus 1e-6 of the largest update, for the
    tensors whose update is a thousandth of it), but for the conv biases before a BN
    (ROADMAP C.11: both rounding noise) and the block of C.20."""
    w0 = _params(run["weights"])
    r0, r1 = (_params({k[len(case) + 1:]: v for k, v in r.items()
                       if k.startswith(case + ".")}) for r in run["ranks"])
    for k in w0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    got = _update(r0, w0)
    ref = _update(_params(run["port"][case][1]), w0)
    top = max(np.abs(v).max() for v in ref.values())
    assert top > 0
    for k in w0:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5 * top,
                                   err_msg=k)
    jref = _update(_params(run["jax"][case][2]), w0)
    dot = sum(float((got[k] * jref[k]).sum()) for k in w0
              if not k.startswith(KINK))
    norm = sum(float((jref[k] ** 2).sum()) for k in w0
               if not k.startswith(KINK))
    assert dot / norm == pytest.approx(1.0, abs=1e-3)
    checked = 0
    for k, j in jref.items():
        if k.startswith(KINK):
            continue
        if ".conv" in k and k.endswith(".bias"):
            wg = np.abs(jref[k[:-5] + ".weight"]).max()
            assert np.abs(j).max() <= 1e-3 * wg, k
            assert np.abs(got[k]).max() <= 1e-3 * wg, k
            continue
        np.testing.assert_allclose(got[k], j, rtol=0,
                                   atol=1e-3 * np.abs(j).max() + 1e-6 * top,
                                   err_msg=k)
        checked += 1
    assert checked > 30
    assert run["port"][case][0] == pytest.approx(run["jax"][case][0], rel=1e-4)


def test_dp_adam_params_match_jax(run):
    """One Adam step: within 2e-4 absolute of the port's unsharded step
    (``tests/test_sharding.py:81-91``'s bound), and within 2·lr of JAX's
    DP step: Adam's first step moves each parameter by about lr·sign(g),
    and where g is rounding noise (ROADMAP C.11) or carries the flip of
    C.20 the sign can differ between the packages
    (``test_torch_train_3d.py``)."""
    case = "global-adam"
    r0 = {k[len(case) + 1:]: v for k, v in run["ranks"][0].items()
          if k.startswith(case + ".")}
    psd = run["port"][case][1]
    for k, v in _params(run["jax"][case][2]).items():
        np.testing.assert_allclose(r0[k], psd[k], rtol=0, atol=2e-4,
                                   err_msg=k)
        np.testing.assert_allclose(r0[k], v, rtol=0,
                                   atol=2 * TW.LR_ADAM * (1 + 1e-4), err_msg=k)


@pytest.mark.parametrize("case", ["global-sgd", "kernel-sgd"])
def test_dp_running_stats_are_the_frame_mean(run, case):
    """The BN running statistics after the step are the mean of the 4
    frames' updates (ROADMAP C.2), not rank 0's: JAX's batch statistics
    within 1e-5, and the port's unsharded step's."""
    r0 = {k[len(case) + 1:]: v for k, v in run["ranks"][0].items()
          if k.startswith(case + ".")}
    jsd, psd = run["jax"][case][2], run["port"][case][1]
    names = [k for k in jsd if k.endswith(STATS)]
    assert len(names) > 10
    for k in names:
        assert not np.array_equal(jsd[k], run["weights"][k]), k
        np.testing.assert_allclose(r0[k], jsd[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(r0[k], psd[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_two_process_train_step(run):
    """``tests/test_multihost.py:31-65``'s check: each rank loads its own
    stride of a shuffled global order (``process_local_indices``), keeps it
    on its device (``assemble_global_batch``), and two DP steps give the
    same loss on every rank."""
    losses = [float(r["multihost.loss"]) for r in run["ranks"]]
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)
    mine = [r["multihost.mine"] for r in run["ranks"]]
    order = np.random.default_rng(0).permutation(2 * RANKS)
    assert sorted(np.concatenate(mine).tolist()) == sorted(order.tolist())

