"""ResNet-18 feature extractor (counterpart of
``pose_splatter_tpu/models/resnet.py``).

The visual-pose-embedding pipeline renders each frame to a spherical rig
and takes ImageNet ResNet-18 features of every view, truncated before the
FC: [B, 512] (the reference's ``calculate_visual_features.py:224-228``).
Topology: conv7x7/2 → max-pool 3x3/2 (padding 1, as Flax's −inf padding)
→ 4 stages of 2 BasicBlocks → global average pool. BatchNorm runs on its
running statistics (ε = 1e-5).

Parameter and buffer names follow torchvision's ``resnet18`` (``conv1``,
``bn1``, ``layer{1-4}.{0,1}.conv1/bn1/conv2/bn2/downsample.{0,1}``), so a
torchvision state dict loads with ``load_state_dict(strict=False)``, its
``fc.*`` keys left out (:func:`load_resnet_weights` names them). The
module takes NHWC images like the Flax one.

ImageNet weights are not bundled; supply a torchvision ``.pth`` or an
``.npz`` with the same keys. Without weights the module starts as Flax's
does (``lecun_normal`` convolutions, BN scale 1 / bias 0, running mean 0 /
variance 1) from an explicit generator, so the pipeline still runs end to
end with untrained features.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pose_splatter_torch.models.unet3d import flax_init_
from pose_splatter_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _conv(cin: int, cout: int, k: int, stride: int, pad: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        # Flax adds the projection where the residual's shape changes.
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride, 0),
                                         nn.BatchNorm2d(cout, eps=1e-5))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """Feature extractor: [B, H, W, 3] (NHWC) → [B, 512]."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), features=(64, 128, 256, 512)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for stage, (n_blocks, feats) in enumerate(zip(stage_sizes, features)):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(cin, feats, stride))
                cin = feats
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))  # [B, 512]


def preprocess_imagenet(rgb: torch.Tensor) -> torch.Tensor:
    """Normalize [.., H, W, 3] images in [0,1] with ImageNet statistics
    (the reference's ``calculate_visual_features.py:228``)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.as_tensor(IMAGENET_STD, device=rgb.device)
    return (rgb - mean) / std


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet18`` state dict from a ``.pth`` file or an
    ``.npz`` with the same keys (float32 CPU tensors)."""
    if path.endswith(".npz"):
        with np.load(path) as flat:
            return {k: torch.from_numpy(np.asarray(flat[k])) for k in flat.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def load_resnet_weights(model: ResNet18, state_dict: Dict[str, torch.Tensor]
                        ) -> Tuple[str, ...]:
    """Load ``state_dict`` into ``model``; returns the keys left out (the
    ``fc.*`` classifier head of a torchvision file). Any other missing or
    unexpected key raises."""
    result = model.load_state_dict(state_dict, strict=False)
    unexpected = tuple(result.unexpected_keys)
    if result.missing_keys or any(not k.startswith("fc.") for k in unexpected):
        raise KeyError(f"resnet18 weights: missing {result.missing_keys}, "
                       f"unexpected {list(unexpected)}")
    return unexpected


def create_feature_extractor(
    weights: Union[str, Mapping[str, torch.Tensor], None] = None,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], ResNet18]:
    """Returns (extract: [B,H,W,3] in [0,1] → [B,512], the module) on
    ``device``. Weights from ``weights``: a file (torchvision keys, ``.pth``
    or ``.npz``) or a state dict with those keys; else Flax's initialisers
    drawn from ``generator`` (default: a CPU generator seeded 0)."""
    dev = resolve_device(device)
    model = ResNet18()
    if isinstance(weights, str):
        weights = load_torch_state_dict(weights)
    if weights is not None:
        dropped = load_resnet_weights(model, weights)
        if dropped:
            print(f"resnet18: left out {', '.join(dropped)}")
    else:
        # Flax's lecun_normal convolutions; a new BatchNorm2d already holds
        # Flax's scale 1 / bias 0 and running mean 0 / variance 1.
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        flax_init_(model, generator)
    model.to(dev).eval()

    @torch.no_grad()
    def extract(rgb: torch.Tensor) -> torch.Tensor:
        return model(preprocess_imagenet(rgb))

    return extract, model
