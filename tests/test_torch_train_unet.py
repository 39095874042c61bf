"""The port's U-Nets in train mode against the Flax modules: max-pool tie
gradients, BatchNorm on batch statistics with Flax's running-statistics
rule, outputs, new statistics and parameter gradients of ``Unet3D`` and
``process_volume``, and the initialisers. Weights, statistics and Flax's
gradients move through ``pose_splatter_torch.bridge`` (a linear relayout,
so it carries gradients too)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from pose_splatter_tpu.models.pose_splatter import PoseSplatterNet as JNet
from pose_splatter_tpu.models.unet3d import Unet3D as JUnet
from pose_splatter_tpu.models.unet3d import _max_pool3d as jpool
from pose_splatter_tpu.models.unet3d import init_unet_primary_skip as jinit_skip
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatterNet as TNet
from pose_splatter_torch.models.unet3d import BatchNorm, _max_pool3d
from pose_splatter_torch.models.unet3d import Unet3D as TUnet
from pose_splatter_torch.models.unet3d import init_unet_primary_skip
from test_torch_unet_bridge import _unet_sd, random_variables

torch.set_num_threads(1)

SIZE = (16, 32, 16)  # the bottleneck level keeps 2 voxels, so its BN is live


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_max_pool_tie_gradient_matches_jax():
    """Trap: a window with a partial tie. Three successive 2-way maxes (JAX's
    order d, h, w) route the gradient [1/4, 1/2, 1/4]; one max over the 8
    taps would route 1/3 to each."""
    x = np.zeros((1, 2, 2, 2, 1), np.float32)  # NDHWC, one window
    for d, h, w in [(0, 0, 0), (1, 0, 0), (0, 1, 1)]:
        x[0, d, h, w, 0] = 1.0
    ref = np.asarray(jax.grad(lambda v: jpool(v).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_(True)
    _max_pool3d(xt).sum().backward()
    got = xt.grad.permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_array_equal(ref, got)
    assert sorted(got[x > 0].tolist()) == [0.25, 0.25, 0.5]
    one_max = torch.from_numpy(x).requires_grad_(True)
    one_max.amax(dim=(1, 2, 3)).sum().backward()
    assert not np.array_equal(one_max.grad.numpy(), got)


def test_batchnorm_follows_flax():
    """Trap: Flax normalises with E[x²] − E[x]² (clipped at 0) and stores
    0.9·old + 0.1·batch with the BIASED variance; ``nn.BatchNorm3d`` stores
    the unbiased one."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (1, 3, 4, 4, 4)).astype(np.float32)  # NCDHW
    mean0 = rng.normal(0, 0.2, 3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    bias = rng.normal(0, 0.1, 3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    y, new = bn.apply(variables, xj, mutable=["batch_stats"])

    tb = BatchNorm(3)
    tb.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    stats = {}
    yt = tb(torch.from_numpy(x), stats)
    np.testing.assert_allclose(np.moveaxis(np.asarray(y), -1, 1),
                               yt.detach().numpy(), atol=1e-6)
    got_mean, got_var = stats[tb]
    np.testing.assert_allclose(np.asarray(new["batch_stats"]["mean"]),
                               got_mean.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(new["batch_stats"]["var"]),
                               got_var.numpy(), rtol=1e-6)
    # The stored variance is the biased one (n = 64 per channel).
    biased = x.var(axis=(0, 2, 3, 4))
    np.testing.assert_allclose(got_var.numpy(), 0.9 * var0 + 0.1 * biased,
                               rtol=1e-5)
    assert torch.equal(tb.running_mean, torch.from_numpy(mean0))  # not written


def _torch_grads(net):
    return {k: p.grad for k, p in net.named_parameters()}


def test_process_volume_train_matches_flax():
    """``process_volume`` in train mode with 2 U-Nets (an intermediate one
    and the final one) of width 4: output, new statistics and parameter
    gradients. The intermediate U-Net's gradients are exactly 0 in JAX and
    None here (its body runs without a graph); its statistics update."""
    rng = np.random.default_rng(3)
    vol = rng.uniform(0, 1, (1, *SIZE, 4)).astype(np.float32)
    cot = rng.normal(0, 1, (8, int(np.prod(SIZE)))).astype(np.float32)
    jnet = JNet(in_channels=4, out_channels=8, base_filters=4, num_unets=2,
                input_size=SIZE, num_gaussian_params=9)
    variables = random_variables(jnet, jnp.asarray(vol), seed=2, train=False)

    def f(params):
        out, new = jnet.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jnp.asarray(vol), True, method="process_volume",
                              mutable=["batch_stats"])
        return (out * cot).sum(), (out, new)

    (_, (ref_out, ref_new)), ref_grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))

    tnet = TNet(4, 8, 4, num_unets=2, input_size=SIZE, num_gaussian_params=9)
    tnet.load_state_dict(variables_from_flax(variables))
    new_stats = {}
    out = tnet.process_volume(torch.from_numpy(vol), new_stats)
    (out * torch.from_numpy(cot)).sum().backward()

    # float32 convolutions and BN reductions summed in another order; BN on
    # batch statistics divides by each channel's batch std, which amplifies
    # that rounding where a channel's spread is small.
    np.testing.assert_allclose(np.asarray(ref_out), out.detach().numpy(),
                               atol=1e-4)
    ref_sd = variables_from_flax({"params": _np(ref_grads),
                                  "batch_stats": _np(ref_new["batch_stats"])})
    stat_keys = [k for k in ref_sd if k.endswith(("running_mean", "running_var"))]
    assert sorted(stat_keys) == sorted(new_stats)
    for k in stat_keys:
        np.testing.assert_allclose(ref_sd[k].numpy(), new_stats[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert not torch.equal(new_stats[k], tnet.state_dict()[k]), k
    grads = _torch_grads(tnet)
    for k, g in grads.items():
        ref = ref_sd[k].numpy()
        if k.startswith("unets.0."):
            assert g is None and (ref == 0).all(), k
            continue
        if k.startswith(("head", "scale")):
            assert g is None, k  # the head is not on this path
            continue
        if ".conv" in k and k.endswith(".bias"):
            # A conv bias right before a train-mode BN shifts the channel
            # and its batch mean alike: its true gradient is 0, and both
            # sides hold only rounding noise, of either sign.
            wg = grads[k[:-5] + ".weight"].abs().max()
            assert np.abs(ref).max() < 1e-3 * wg and g.abs().max() < 1e-3 * wg, k
            continue
        # Gradients through 14 conv layers and 18 BNs, scaled by the
        # tensor's largest entry. encoder5's BNs see 2 voxels: a batch std
        # of two values amplifies rounding ~10x more (measured 1.2e-3
        # there, under 1e-4 elsewhere).
        rel = 3e-3 if "encoder5" in k else 2e-4
        np.testing.assert_allclose(ref, g.numpy(), rtol=0,
                                   atol=rel * np.abs(ref).max() + 1e-9,
                                   err_msg=k)
    assert any(g is not None and float(g.abs().max()) > 0
               for k, g in grads.items() if "encoder5" in k)


def test_unet3d_eval_and_train_mode_differ_only_by_statistics():
    """Without ``new_stats`` a U-Net reads the running statistics, as the
    Flax ``train=False`` forward does; with it, batch statistics."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (1, 16, 16, 16, 4)).astype(np.float32)
    jm = JUnet(in_channels=4, out_channels=8, base_filters=4,
               input_size=(16, 16, 16))
    variables = random_variables(jm, jnp.asarray(x), seed=5, train=False)
    ref_eval, _ = jm.apply(variables, jnp.asarray(x), train=False)
    (ref_train, _), _ = jm.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    tm = TUnet(4, 8, 4, input_size=(16, 16, 16))
    sd = variables_from_flax({"params": {"unet_0": variables["params"]},
                              "batch_stats": {"unet_0": variables["batch_stats"]}})
    tm.load_state_dict(_unet_sd(sd, "unets.0."))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got_eval = tm(xt).permute(0, 2, 3, 4, 1).numpy()
        got_train = tm(xt, {}).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(np.asarray(ref_eval), got_eval, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref_train), got_train, atol=2e-5)
    assert np.abs(got_eval - got_train).max() > 1e-3


def _layers(net):
    out = {}
    for name, mod in net.named_modules():
        if isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d,
                            torch.nn.Linear)):
            out[name] = mod
    return out


def test_initialisers_follow_flax():
    """Fault repaired: every conv, transpose conv and dense layer starts as
    Flax's would, ``lecun_normal`` (truncated at ±2 std, variance
    1/fan_in with Flax's fan-in) and zero bias, not PyTorch's
    Kaiming-uniform. The fan-ins are read off the Flax kernels' shapes."""
    jnet = JNet(in_channels=4, out_channels=8, base_filters=4, num_unets=2,
                input_size=(16, 16, 16), num_gaussian_params=9)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 4)), train=False))
    kernels = {
        "/".join(str(p.key) for p in path[:-1]): leaf.shape
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0] if path[-1].key == "kernel"}
    torch.manual_seed(0)
    tnet = TNet(4, 8, 4, num_unets=2, input_size=(16, 16, 16),
                num_gaussian_params=9)
    layers = _layers(tnet)
    assert len(layers) == len(kernels)
    key = jax.random.PRNGKey(1)
    checked = 0
    for name, mod in layers.items():
        fname = name.replace("unets.", "unet_").replace(".", "/")
        kshape = kernels[fname]
        fan_in = int(np.prod(kshape[:-1]))
        w = mod.weight.detach().numpy()
        std = np.sqrt(1.0 / fan_in)
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7, name
        assert (mod.bias.detach().numpy() == 0).all(), name
        if w.size >= 2000:  # sampling error of the std under ~5 %
            np.testing.assert_allclose(w.std(), std, rtol=0.06, err_msg=name)
            if "final_unet" in name and "coder5" in name:  # one draw a kind
                flax_w = np.asarray(fnn.initializers.lecun_normal()(key, kshape))
                np.testing.assert_allclose(w.std(), flax_w.std(), rtol=0.1,
                                           err_msg=name)
                checked += 1
    assert checked == 2
    for mod in tnet.modules():
        if isinstance(mod, BatchNorm):
            assert (mod.weight == 1).all() and (mod.bias == 0).all()
            assert (mod.running_mean == 0).all() and (mod.running_var == 1).all()


def test_init_unet_primary_skip_matches_jax():
    """The near-identity fresh start, against the JAX function through the
    bridge: centre-tap identities on encoder1 / decoder1 / final_conv,
    N(0, 1e-4) elsewhere (the heads too), zero biases, BN and the shared
    scale untouched. Draws differ (numpy in another order)."""
    jnet = JNet(in_channels=4, out_channels=8, base_filters=4, num_unets=2,
                input_size=(16, 16, 16), num_gaussian_params=9)
    variables = random_variables(jnet, jnp.zeros((1, 16, 16, 16, 4)), seed=6,
                                 train=False)
    ref = variables_from_flax({
        "params": _np(jinit_skip(variables["params"], in_channels=4)),
        "batch_stats": variables["batch_stats"]})
    tnet = TNet(4, 8, 4, num_unets=2, input_size=(16, 16, 16),
                num_gaussian_params=9)
    tnet.load_state_dict(variables_from_flax(variables))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    init_unet_primary_skip(tnet, in_channels=4)
    got = tnet.state_dict()
    layer_weights = {f"{n}.weight" for n in _layers(tnet)}
    for k, r in ref.items():
        g = got[k]
        if k in layer_weights:
            big = r.abs() > 0.5
            assert torch.equal(big, g.abs() > 0.5), k  # identity taps alike
            assert torch.equal(r[big], g[big]), k
            assert float(g[~big].abs().max()) < 1e-3, k
            if big.any():
                assert "encoder1" in k or "decoder1" in k or "final_conv" in k
        elif k.endswith(".bias") and k[:-5] + ".weight" in layer_weights:
            assert (r == 0).all() and (g == 0).all(), k
        else:  # BN parameters and statistics, the shared scale
            assert torch.equal(r, before[k]) and torch.equal(g, before[k]), k
    centre = got["final_unet.final_conv.weight"][:, :, 0, 0, 0]
    assert torch.equal(torch.diagonal(centre[:4, :4]), torch.ones(4))
