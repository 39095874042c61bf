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
- BatchNorm uses eps 1e-5; in eval mode it reads the running statistics
  exactly as stored.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.1):
        super().__init__()
        self.conv0 = nn.Conv3d(in_features, features, 3, padding=1)
        self.bn0 = nn.BatchNorm3d(features, eps=1e-5, momentum=0.1)
        self.conv1 = nn.Conv3d(features, features, 3, padding=1)
        self.bn1 = nn.BatchNorm3d(features, eps=1e-5, momentum=0.1)
        self.negative_slope = negative_slope

    def forward(self, x):
        x = F.leaky_relu(self.bn0(self.conv0(x)), self.negative_slope)
        return F.leaky_relu(self.bn1(self.conv1(x)), self.negative_slope)


def _max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2×2×2 stride-2 max pool as reshape + max over the window taps
    (``unet3d.py:52-71``)."""
    b, c, d, h, w = x.shape
    x = x.reshape(b, c, d // 2, 2, h // 2, 2, w // 2, 2)
    return x.amax(dim=(3, 5, 7))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.out_channels == self.in_channels and not self.training:
            # The passthrough replaces every output channel by the input, so
            # in eval mode nothing of the body reaches the output. In
            # training the body still runs for its BN statistics.
            return x
        b = x.shape[0]
        bf = self.base_filters
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(_max_pool3d(enc1))
        enc3 = self.encoder3(_max_pool3d(enc2))
        enc4 = self.encoder4(_max_pool3d(enc3))
        enc5 = self.encoder5(_max_pool3d(enc4))

        flat = enc5.permute(0, 2, 3, 4, 1).reshape(b, -1)  # NDHWC order
        z = self.mlp_1b(F.relu(self.mlp_1a(flat)))
        bottleneck = (self.mlp_2(z).reshape(b, *self.ns, bf * 16)
                      .permute(0, 4, 1, 2, 3))

        dec4 = self.decoder4(torch.cat([enc4, self.upconv4(bottleneck)], 1))
        dec3 = self.decoder3(torch.cat([enc3, self.upconv3(dec4)], 1))
        dec2 = self.decoder2(torch.cat([enc2, self.upconv2(dec3)], 1))
        dec1 = self.decoder1(torch.cat([enc1, self.upconv1(dec2)], 1))

        out = self.final_conv(dec1)
        return torch.cat([x, out[:, self.in_channels:]], dim=1)
