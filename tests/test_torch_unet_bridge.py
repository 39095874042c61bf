"""Parity of the port's U-Net and PoseSplatterNet (eval mode) with the Flax
modules, with weights moved through ``pose_splatter_torch.bridge``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_tpu.models.pose_splatter import PoseSplatterNet as JNet
from pose_splatter_tpu.models.unet3d import Unet3D as JUnet
from pose_splatter_torch.bridge import variables_from_flax
from pose_splatter_torch.models.pose_splatter import PoseSplatterNet as TNet
from pose_splatter_torch.models.unet3d import Unet3D as TUnet

torch.set_num_threads(1)

SIZE = (16, 32, 16)


def random_variables(module, *args, seed=0, **kwargs):
    """Seeded Flax variables of ``module`` for inputs ``args`` (shapes from
    ``jax.eval_shape``, values from numpy; Flax's own initializers take
    tens of seconds to compile on the CPU). Kernels are ~N(0, 1/fan_in);
    BN statistics, scales and biases are non-trivial, so eval mode really
    reads mean, var, scale and bias."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def fill(path, leaf):
        key = path[-1].key
        shape = leaf.shape
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif key == "mean":
            x = rng.normal(0, 0.2, shape)
        elif key == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif key == "scale" and shape != (1,):
            x = rng.uniform(0.8, 1.2, shape)
        elif key == "scale":
            x = np.full(shape, -5.5)
        elif key == "bias":
            x = rng.normal(0, 0.05, shape)
        else:
            raise KeyError(key)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _unet_sd(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("out_channels", [8, 4])
def test_unet3d_eval_matches_flax(out_channels):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, *SIZE, 4)).astype(np.float32)
    jm = JUnet(in_channels=4, out_channels=out_channels, base_filters=4,
               input_size=SIZE)
    variables = random_variables(jm, jnp.asarray(x), seed=1, train=False)
    ref, _ = jm.apply(variables, jnp.asarray(x), train=False)

    tm = TUnet(4, out_channels, 4, input_size=SIZE).eval()
    sd = variables_from_flax({"params": {"unet_0": variables["params"]},
                              "batch_stats": {"unet_0": variables["batch_stats"]}})
    tm.load_state_dict(_unet_sd(sd, "unets.0."))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    # float32 convolutions summed in another order over 14 conv layers.
    np.testing.assert_allclose(np.asarray(ref), got, atol=1e-5)
    # Hard passthrough: the first in_channels outputs are the input.
    np.testing.assert_array_equal(got[..., :4], x)


def test_unet3d_body_runs_in_eval_with_extra_channels():
    """The eval short-cut applies only when the passthrough covers every
    output channel; with extra channels the body's output differs."""
    tm = TUnet(4, 8, 4, input_size=SIZE).eval()
    x = torch.rand(1, 4, *SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tm(x)
    assert out.shape == (1, 8, *SIZE)
    assert not torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))


def test_pose_splatter_net_process_volume_and_head():
    rng = np.random.default_rng(3)
    vol = rng.uniform(0, 1, (1, *SIZE, 4)).astype(np.float32)
    jnet = JNet(in_channels=4, out_channels=8, base_filters=4, num_unets=2,
                input_size=SIZE, num_gaussian_params=9)
    variables = random_variables(jnet, jnp.asarray(vol), seed=2, train=False)
    ref_flat = np.asarray(jnet.apply(variables, jnp.asarray(vol), False,
                                     method="process_volume"))
    feats = rng.normal(0, 1, (64, 8)).astype(np.float32)
    ref_head = np.asarray(jnet.apply(variables, jnp.asarray(feats),
                                     method="gaussian_head"))

    tnet = TNet(4, 8, 4, num_unets=2, input_size=SIZE,
                num_gaussian_params=9).eval()
    tnet.load_state_dict(variables_from_flax(variables))
    with torch.no_grad():
        flat = tnet.process_volume(torch.from_numpy(vol)).numpy()
        head = tnet.gaussian_head(torch.from_numpy(feats)).numpy()
    assert flat.shape == (8, int(np.prod(SIZE)))
    np.testing.assert_allclose(ref_flat, flat, atol=1e-5)
    # Channel 0 is 2^(num_unets-1) x the input occupancy, exactly (the
    # residual passthrough), which makes selection ties massive.
    np.testing.assert_array_equal(flat[0], 2.0 * vol[0, ..., 0].reshape(-1))
    np.testing.assert_allclose(ref_head, head, atol=1e-5)
    assert float(tnet.scale.detach()) == pytest.approx(-5.5)
