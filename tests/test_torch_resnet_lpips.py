"""The port's ResNet18 and LPIPS (AlexNet trunk + linear heads) against the
JAX package's Flax modules, with the Flax weights carried across by
``bridge.resnet_from_flax`` / ``bridge.alexnet_from_flax``; the weight
files both packages read (a torchvision-key ``.pth`` built here, since
torchvision is not installed, its ``.npz``, the LPIPS ``.npz`` and torch
files); and Flax's initialisers for a ResNet18 without weights.

Features are compared within 1e-5 of the largest |feature| (float32
convolutions summed in another order), LPIPS distances at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_tpu.models import resnet as jresnet
from pose_splatter_tpu.ops import lpips as jlpips
from pose_splatter_torch.bridge import alexnet_from_flax, resnet_from_flax
from pose_splatter_torch.models import resnet as tresnet
from pose_splatter_torch.ops import lpips as tlpips

torch.set_num_threads(1)

SHAPES = [(2, 64, 64), (1, 224, 224)]


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape + (3,)).astype(np.float32)


def _close_to_largest(got, ref, rel):
    ref = np.asarray(ref)
    bound = rel * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)


@pytest.fixture(scope="module")
def resnet_vars():
    """Flax ResNet18 variables with random BN statistics and affine
    parameters (Flax's init leaves them at 0/1, which would hide a layout
    fault in the bridge)."""
    variables = jresnet.ResNet18().init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.default_rng(1)

    def perturb(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x64x64", "1x224x224"])
def test_resnet18_matches_flax(resnet_vars, shape):
    x = _images(shape, seed=2)
    ref = jresnet.ResNet18().apply(resnet_vars, jnp.asarray(x), False)
    model = tresnet.ResNet18()
    model.load_state_dict(resnet_from_flax(resnet_vars))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (shape[0], 512)
    _close_to_largest(got.numpy(), ref, 1e-5)


def test_resnet18_feature_extractor_matches_flax(resnet_vars, tmp_path):
    """``create_feature_extractor`` (ImageNet normalisation + the net) on a
    weights file written from the Flax variables in torchvision's keys:
    the ``.npz`` both packages read."""
    sd = resnet_from_flax(resnet_vars)
    path = str(tmp_path / "resnet18.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    x = _images((2, 64, 64), seed=3)
    j_extract, _ = jresnet.create_feature_extractor(path)
    t_extract, _ = tresnet.create_feature_extractor(path, device="cpu")
    _close_to_largest(t_extract(torch.from_numpy(x)).numpy(),
                      j_extract(jnp.asarray(x)), 1e-5)


def test_load_torch_state_dict_pth_and_npz(resnet_vars, tmp_path):
    """A torchvision-key ``.pth`` (with the classifier head) and its
    ``.npz`` load to the same module; the ``fc.*`` keys are left out and
    named."""
    sd = resnet_from_flax(resnet_vars)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    pth, npz = str(tmp_path / "r.pth"), str(tmp_path / "r.npz")
    torch.save(sd, pth)
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    x = torch.from_numpy(_images((1, 64, 64), seed=4))
    outs = []
    for path in (pth, npz):
        model = tresnet.ResNet18()
        dropped = tresnet.load_resnet_weights(
            model, tresnet.load_torch_state_dict(path))
        assert sorted(dropped) == ["fc.bias", "fc.weight"]
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
    # The JAX package's converter reads the same .pth to the same features.
    ref = jresnet.ResNet18().apply(jresnet.load_torch_state_dict(pth),
                                   jnp.asarray(x.numpy()), False)
    _close_to_largest(outs[0].numpy(), ref, 1e-5)
    with pytest.raises(KeyError):
        tresnet.load_resnet_weights(tresnet.ResNet18(),
                                    {k: v for k, v in sd.items() if k != "conv1.weight"})


def test_resnet18_initialises_as_flax():
    """Without weights: ``lecun_normal`` convolutions (truncated at ±2σ,
    variance 1/fan_in), BN scale 1 / bias 0, running mean 0 / var 1, drawn
    from the generator (same seed, same weights)."""
    g = torch.Generator().manual_seed(5)
    _, m1 = tresnet.create_feature_extractor(None, device="cpu", generator=g)
    _, m2 = tresnet.create_feature_extractor(
        None, device="cpu", generator=torch.Generator().manual_seed(5))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    w = m1.layer3[0].conv1.weight.detach()  # fan_in 128·3·3
    std = (1.0 / (128 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    bn = m1.layer3[0].bn1
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert not m1.training


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """The JAX package's LPIPS ``.npz`` with random weights (HWIO kernels,
    biases, positive heads)."""
    rng = np.random.default_rng(6)
    d, cin = {}, 3
    for i, (f, k, _, _) in enumerate(jlpips._ALEX_CFG):
        fan_in = cin * k * k
        d[f"conv{i}_kernel"] = rng.normal(0, fan_in ** -0.5, (k, k, cin, f)).astype(np.float32)
        d[f"conv{i}_bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        d[f"lin{i}"] = rng.uniform(0, 1, f).astype(np.float32)
        cin = f
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    np.savez(path, **d)
    return path


@pytest.mark.parametrize("shape", SHAPES, ids=["2x64x64", "1x224x224"])
def test_alexnet_taps_match_flax(lpips_weights, shape):
    jw = jlpips.load_weights(lpips_weights)
    x = _images(shape, seed=7) * 2 - 1
    taps_j = jlpips.AlexNetFeatures().apply({"params": jw["params"]}, jnp.asarray(x))
    tw = alexnet_from_flax(jax.device_get(jw["params"]), jax.device_get(jw["lins"]))
    model = tlpips.AlexNetFeatures()
    model.load_state_dict(tw["features"])
    with torch.no_grad():
        taps_t = model(torch.from_numpy(x))
    assert len(taps_t) == len(taps_j) == 5
    for a, b in zip(taps_t, taps_j):
        _close_to_largest(a.permute(0, 2, 3, 1).numpy(), b, 1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x64x64", "1x224x224"])
def test_lpips_matches_flax(lpips_weights, shape):
    x, y = _images(shape, seed=8), _images(shape, seed=9)
    ref = jlpips.create_lpips(lpips_weights)(jnp.asarray(x), jnp.asarray(y))
    got = tlpips.create_lpips(lpips_weights, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    same = tlpips.create_lpips(lpips_weights, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(x))
    assert float(same.abs().max()) == 0.0


def test_lpips_torch_files_load_directly(lpips_weights, tmp_path):
    """torchvision's ``alexnet.pth`` (classifier included) and the lpips
    package's ``lpips_alex.pth`` load as they are, the heads as |w|, to the
    distances of the same weights in the JAX package's torch-file path."""
    jw = jlpips.load_weights(lpips_weights)
    tw = alexnet_from_flax(jax.device_get(jw["params"]), jax.device_get(jw["lins"]))
    alex = dict(tw["features"])
    alex["classifier.1.weight"] = torch.zeros(4096, 9216)
    torch.save(alex, tmp_path / "alexnet.pth")
    signs = torch.tensor([-1.0, 1.0])
    torch.save({f"lin{i}.model.1.weight":
                (w * signs.repeat(len(w) // 2 + 1)[:len(w)]).reshape(1, -1, 1, 1)
                for i, w in enumerate(tw["lins"])}, tmp_path / "lpips_alex.pth")
    loaded = tlpips.load_weights(str(tmp_path))
    for a, b in zip(loaded["lins"], tw["lins"]):
        assert torch.equal(a, b)
    x, y = _images((2, 64, 64), seed=10), _images((2, 64, 64), seed=11)
    got = tlpips.create_lpips(str(tmp_path), device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y))
    ref = jlpips.create_lpips(str(tmp_path))(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_create_lpips_without_weights_is_none(tmp_path):
    assert tlpips.create_lpips(None) is None
    assert tlpips.create_lpips(str(tmp_path / "missing.npz"), device="cpu") is None
