"""The net's weights, made on the device from the seed in a few large draws.

The U-Nets take the model's own initial weights: each conv,
transpose-conv and dense weight a normal truncated at two standard
deviations with variance 1/fan_in (Flax's ``lecun_normal``); zero biases;
BatchNorm scale 1 and shift 0, running mean 0 and variance 1. The
Gaussian head (``head1``, ``head2``) is as ``train_from_config``'s fresh
start leaves it, every weight N(0, 1e-4), and the shared log-scale is
log(2) in 2D (``init_means2d_center``), -5.5 in 3D: the Gaussians start at
the fresh start's sizes and places, the few pixels a trained model keeps,
while every U-Net layer carries a gradient of its own scale. (From the
whole fresh start, whose U-Net weights are N(0, 1e-4) too, most leaves'
gradients lie many orders of magnitude below the round-off of the
BN-cancelled biases; with the head at its initial weights too, the seed's
head sets every Gaussian's size, and the binning drops up to nine rows in
ten.)

Both sides get the same dict: the program by ``load_state_dict``, the
reference as it is.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import Spec, layers, param_shapes

def _fan_in(kind: str, shape) -> int:
    if kind == "tconv":
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter and buffer."""
    shapes = param_shapes(spec)
    weighted = [(n, k, s) for n, k, s in layers(spec) if k != "bn"]
    total = sum(math.prod(s) for _, _, s in weighted)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # A unit normal truncated at +-2 by its inverse CDF, from one draw.
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    draw = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo))
                                          - 1.0)).float()
    heads = sum(math.prod(s) for n, _, s in weighted if n.startswith("head"))
    normal = 1e-4 * torch.randn(heads, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = at_head = 0
    for name, kind, shape in weighted:
        n = math.prod(shape)
        w = draw[at:at + n].reshape(shape)
        at += n
        if name.startswith("head"):
            w = normal[at_head:at_head + n].reshape(shape)
            at_head += n
        else:
            w = w * ((1.0 / _fan_in(kind, shape)) ** 0.5 / 0.87962566103423978)
        out[f"{name}.weight"] = w.contiguous()
    for name, shape in shapes.items():
        if name in out:
            continue
        if name == "scale":
            value = math.log(2.0) if spec.mode == "2d" else -5.5
            out[name] = torch.full(shape, value, dtype=torch.float32, device=device)
        elif name.endswith("running_var") or (name.endswith(".weight")
                                              and ".bn" in name):
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
