"""3D U-Net with an MLP bottleneck (NCDHW).

Counterpart of ``pose_splatter_tpu/models/unet3d.py``: a 5-level encoder of
(Conv3x3x3 → BN → LeakyReLU(0.1)) × 2 blocks with 2×2×2 max pooling, an
MLP bottleneck, a 4-level transpose-conv decoder with skip concatenation,
a final 1×1×1 conv and the hard input passthrough (the first
``in_channels`` output channels are the input).

Layout notes for parity with the Flax module (weights move through
:mod:`pose_splatter_torch.bridge`):

- tensors are NCDHW here, NDHWC there;
- the bottleneck is flattened and unflattened in NDHWC order
  (``unet3d.py:120-121``) so ``mlp_1a`` / ``mlp_2`` keep Flax's row order;
- BatchNorm follows ``flax.linen.BatchNorm`` (:class:`BatchNorm`).

Train and eval mode follow the Flax ``train`` flag, not ``nn.Module.training``:
a forward given a ``new_stats`` dict normalises with batch statistics and
fills the dict with the updated running statistics instead of writing them
(Flax's ``mutable=["batch_stats"]``); without it, the running statistics
are read as stored.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pose_splatter_torch.ops.conv3d import conv3d

# Collects, per BatchNorm module, its updated (running_mean, running_var).
NewStats = Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def flax_init_(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> None:
    """Flax's default initialisers for every conv, transpose-conv and dense
    layer in ``module``, in place: ``lecun_normal`` weights (a normal
    truncated at ±2 standard deviations, rescaled to variance 1/fan_in) and
    zero biases, drawn from ``generator`` (default: the global RNG).
    Fan-in as Flax counts it on its own kernel layout: ``in`` for
    ``nn.Dense``, ``in · kd·kh·kw`` (2D: ``in · kh·kw``) for ``nn.Conv`` and
    ``nn.ConvTranspose`` (torch keeps a transpose conv's ``in`` on axis 0)."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = mod.weight[0].numel()
        elif isinstance(mod, nn.ConvTranspose3d):
            fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
        else:
            continue
        # Flax: stddev = sqrt(1 / fan_in) / 0.8796..., the std of a unit
        # normal truncated at ±2.
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if mod.bias is not None:
            nn.init.zeros_(mod.bias)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of NCDHW input.

    Train mode: mean and variance over (N, D, H, W), the variance by the
    fast formula E[x²] − E[x]² clipped at 0 (Flax's ``use_fast_variance``),
    and new running statistics 0.9·old + 0.1·batch with the *biased*
    variance (``nn.BatchNorm3d`` would store the unbiased one). Both modes
    normalise as Flax's ``_normalize``: (x − mean) · (scale · rsqrt(var +
    eps)) + bias.
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                new_stats: Optional[NewStats] = None) -> torch.Tensor:
        if new_stats is None:
            mean, var = self.running_mean, self.running_var
        else:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            m = self.momentum
            new_stats[self] = (m * self.running_mean + (1 - m) * mean.detach(),
                               m * self.running_var + (1 - m) * var.detach())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ConvBlock(nn.Module):
    """(Conv3x3x3 → BN → LeakyReLU) × 2. In a train step on the card each
    conv whose shape ``ops/conv3d.py::takes`` takes its weight and bias
    gradients from the hand-written kernel (``ops/conv3d.py::conv3d``);
    the forward is the module's own in every case."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.1):
        super().__init__()
        self.conv0 = nn.Conv3d(in_features, features, 3, padding=1)
        self.bn0 = BatchNorm(features)
        self.conv1 = nn.Conv3d(features, features, 3, padding=1)
        self.bn1 = BatchNorm(features)
        self.negative_slope = negative_slope

    def forward(self, x, new_stats: Optional[NewStats] = None):
        x = F.leaky_relu(self.bn0(conv3d(self.conv0, x), new_stats),
                         self.negative_slope)
        return F.leaky_relu(self.bn1(conv3d(self.conv1, x), new_stats),
                            self.negative_slope)


def _max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2×2×2 stride-2 max pool as three successive 2-way maxes over d, then
    h, then w (``unet3d.py:68-71``). The forward equals one max over the 8
    taps, but the backward does not: each 2-way max splits its gradient
    evenly at a tie, so a window with a partial tie routes its gradient as
    the JAX package does only in this order."""
    b, c, d, h, w = x.shape
    x = x.reshape(b, c, d // 2, 2, h, w).amax(dim=3)
    x = x.reshape(b, c, d // 2, h // 2, 2, w).amax(dim=4)
    return x.reshape(b, c, d // 2, h // 2, w // 2, 2).amax(dim=5)


class Unet3D(nn.Module):
    """x [B, in_channels, D, H, W] → [B, out_channels, D, H, W]."""

    def __init__(self, in_channels: int = 4, out_channels: int = 8,
                 base_filters: int = 8, z_dim: int = 512,
                 input_size: Sequence[int] = (80, 80, 48)):
        super().__init__()
        for s in input_size:
            if s % 16:
                raise ValueError(f"input extent {s} not divisible by 16")
        bf = base_filters
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_filters = bf
        self.ns = tuple(int(s) // 16 for s in input_size)
        n_prod = self.ns[0] * self.ns[1] * self.ns[2]

        self.encoder1 = ConvBlock(in_channels, bf)
        self.encoder2 = ConvBlock(bf, bf * 2)
        self.encoder3 = ConvBlock(bf * 2, bf * 4)
        self.encoder4 = ConvBlock(bf * 4, bf * 8)
        self.encoder5 = ConvBlock(bf * 8, bf * 16)

        self.mlp_1a = nn.Linear(bf * 16 * n_prod, 512)
        self.mlp_1b = nn.Linear(512, z_dim)
        self.mlp_2 = nn.Linear(z_dim, bf * 16 * n_prod)

        self.upconv4 = nn.ConvTranspose3d(bf * 16, bf * 8, 2, stride=2)
        self.decoder4 = ConvBlock(bf * 16, bf * 8)
        self.upconv3 = nn.ConvTranspose3d(bf * 8, bf * 4, 2, stride=2)
        self.decoder3 = ConvBlock(bf * 8, bf * 4)
        self.upconv2 = nn.ConvTranspose3d(bf * 4, bf * 2, 2, stride=2)
        self.decoder2 = ConvBlock(bf * 4, bf * 2)
        self.upconv1 = nn.ConvTranspose3d(bf * 2, bf, 2, stride=2)
        self.decoder1 = ConvBlock(bf * 2, bf)
        self.final_conv = nn.Conv3d(bf, out_channels, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor,
                new_stats: Optional[NewStats] = None) -> torch.Tensor:
        if self.out_channels == self.in_channels:
            # The passthrough replaces every output channel by the input, so
            # nothing of the body reaches the output. In eval mode the body
            # is skipped. In train mode it runs for its BN statistics only,
            # without a graph: its parameters' gradients stay None where
            # JAX's are exactly 0, and Adam moves neither (torch.optim skips
            # a parameter whose grad is None; optax's update of a zero
            # gradient with zero moments is 0).
            if new_stats is not None:
                with torch.no_grad():
                    self._body(x, new_stats)
            return x
        out = self._body(x, new_stats)
        return torch.cat([x, out[:, self.in_channels:]], dim=1)

    def _body(self, x, new_stats):
        b = x.shape[0]
        bf = self.base_filters
        enc1 = self.encoder1(x, new_stats)
        enc2 = self.encoder2(_max_pool3d(enc1), new_stats)
        enc3 = self.encoder3(_max_pool3d(enc2), new_stats)
        enc4 = self.encoder4(_max_pool3d(enc3), new_stats)
        enc5 = self.encoder5(_max_pool3d(enc4), new_stats)

        flat = enc5.permute(0, 2, 3, 4, 1).reshape(b, -1)  # NDHWC order
        z = self.mlp_1b(F.relu(self.mlp_1a(flat)))
        bottleneck = (self.mlp_2(z).reshape(b, *self.ns, bf * 16)
                      .permute(0, 4, 1, 2, 3))

        dec4 = self.decoder4(torch.cat([enc4, self.upconv4(bottleneck)], 1), new_stats)
        dec3 = self.decoder3(torch.cat([enc3, self.upconv3(dec4)], 1), new_stats)
        dec2 = self.decoder2(torch.cat([enc2, self.upconv2(dec3)], 1), new_stats)
        dec1 = self.decoder1(torch.cat([enc1, self.upconv1(dec2)], 1), new_stats)
        return self.final_conv(dec1)


@torch.no_grad()
def init_unet_primary_skip(net: nn.Module, in_channels: int = 4,
                           small_scale: float = 1e-4, seed: int = 0) -> None:
    """Near-identity re-initialisation, in place (``unet3d.py:138-175``).

    Like the JAX function, which maps over the whole parameter tree it is
    given: every conv / transpose-conv / dense weight becomes
    ~N(0, ``small_scale``), except that the convs of ``encoder1``,
    ``decoder1`` and ``final_conv`` also get a centre-tap identity on the
    first ``min(in_channels, in, out)`` channels; every bias becomes 0;
    BatchNorm parameters and any other parameter (the model's shared
    ``scale``) are left as they are. Draws come from numpy's
    ``default_rng(seed)`` in parameter order, so they differ from the JAX
    package's (which walks its tree in another order).
    """
    rng = np.random.default_rng(seed)
    for mname, mod in net.named_modules():
        if not isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            continue
        w = mod.weight
        new = rng.normal(0.0, small_scale, tuple(w.shape))
        primary = any(k in mname for k in ("encoder1", "decoder1", "final_conv"))
        if isinstance(mod, nn.Conv3d) and primary:
            cout, cin, kd, kh, kw = w.shape  # torch layout [out, in, kd, kh, kw]
            for i in range(min(in_channels, cin, cout)):
                new[i, i, kd // 2, kh // 2, kw // 2] = 1.0
        w.copy_(torch.as_tensor(new, dtype=w.dtype))
        mod.bias.zero_()
