"""ResNet-18's FLOPs, counted from its layer shapes, and its weights, made
on the device from the seed.

FLOPs: every convolution (two a multiply-add) at its output's size for an
S x S input: the 7x7/2 stem, the 3x3 convolutions of the 8 BasicBlocks and
the three 1x1 projections; BatchNorm, ReLU, the pools and the residual
adds are left out (under 1 % of the convolutions' count). At 224^2 that is
1.814 GMAC an image.

Weights: each convolution a normal truncated at two standard deviations
with variance 1/fan_in (Flax's ``lecun_normal``, as the program's
``create_feature_extractor`` draws them without a file), BatchNorm at the
identity (scale 1, shift 0, running mean 0 and variance 1). ImageNet's
weights are not in the repository. Both sides get the same dict: the
program through ``make_frame_features``' ``resnet_weights``, the reference
as it is.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.features import bn_name, resnet_layers

# An independent stream of the seed (``program.py`` keeps the others).
WEIGHTS_STREAM = 3_000_003


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def flops(size: int) -> int:
    """FLOPs of one size x size image through ResNet-18's convolutions."""
    s = _out(size, 7, 2)          # the stem
    total = 2 * 3 * 64 * 49 * s * s
    s = _out(s, 3, 2)             # the max-pool: a block's input size
    for name, cin, cout, k, stride in resnet_layers()[1:]:
        # conv1 reads the block's input; conv2 and the projection give
        # conv1's output size, which is the next block's input.
        o = s if name.endswith("downsample.0") else _out(s, k, stride)
        total += 2 * cin * cout * k * k * o * o
        if name.endswith("conv1"):
            s = o
    return total


def parameters() -> int:
    """Parameters without ``fc``: the convolutions and BatchNorm's scale
    and shift."""
    return sum(cin * cout * k * k + 2 * cout for _, cin, cout, k, _ in resnet_layers())


def make_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for every parameter and buffer of the
    program's ``ResNet18`` (torchvision's names), from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + WEIGHTS_STREAM)
    layers = resnet_layers()
    total = sum(cin * cout * k * k for _, cin, cout, k, _ in layers)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    draw = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo))
                                          - 1.0)).float()
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, cin, cout, k, _ in layers:
        n = cin * cout * k * k
        std = (1.0 / (cin * k * k)) ** 0.5 / 0.87962566103423978
        out[f"{name}.weight"] = (draw[at:at + n] * std).reshape(cout, cin, k, k)
        at += n
        bn = bn_name(name)
        f32 = dict(dtype=torch.float32, device=device)
        out[f"{bn}.weight"] = torch.ones(cout, **f32)
        out[f"{bn}.bias"] = torch.zeros(cout, **f32)
        out[f"{bn}.running_mean"] = torch.zeros(cout, **f32)
        out[f"{bn}.running_var"] = torch.ones(cout, **f32)
        out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                       device=device)
    return out
