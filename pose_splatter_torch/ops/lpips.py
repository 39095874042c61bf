"""LPIPS perceptual metric with the AlexNet backbone (counterpart of
``pose_splatter_tpu/ops/lpips.py``).

LPIPS is optional, as in the reference (torchmetrics + AlexNet, skipped
when unavailable; ``evaluate_model.py:20-27``): the weights must be given as
a file, either the JAX package's converted ``.npz`` or a directory holding
torchvision's AlexNet state dict (``alexnet.pth``) and the lpips package's
linear heads (``lpips_alex.pth``), which load as they are: the trunk keeps
torchvision's ``features.{0,3,6,8,10}`` names. Without weights
:func:`create_lpips` returns None and callers skip the metric.

LPIPS(x, y) = Σ_l mean_hw Σ_c w_l,c · (n(f_l(x)) − n(f_l(y)))²_c, with
n(f) = f / (‖f‖_c + 1e-10), inputs mapped to [-1, 1] and shifted/scaled by
the standard constants. The trunk's pools are VALID (``MaxPool2d(3, 2)``).
The taps are NCHW here (channels on axis 1), NHWC in the Flax module.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from pose_splatter_torch.utils.device import resolve_device

# LPIPS input normalization (matches the official implementation).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet conv trunk: (features, kernel, stride, padding), and the index of
# each conv in torchvision's ``alexnet.features``.
_ALEX_CFG = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_TORCH_IDX = [0, 3, 6, 8, 10]
# Max-pool after these conv indices.
_POOL_AFTER = {0, 1}


class AlexNetFeatures(nn.Module):
    """[B, H, W, 3] (NHWC) → the 5 post-ReLU conv feature maps (LPIPS
    taps), each [B, C_l, H_l, W_l]."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for i, (f, k, s, p) in enumerate(_ALEX_CFG):
            layers += [nn.Conv2d(cin, f, k, s, p), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = f
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        feats = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                feats.append(x)
        return feats


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips_distance(feats_x: Sequence[torch.Tensor],
                   feats_y: Sequence[torch.Tensor],
                   lin_weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-layer unit-normalize, squared diff, 1x1 linear head (no bias),
    spatial mean, summed over layers → [B]."""
    total = 0.0
    for fx, fy, w in zip(feats_x, feats_y, lin_weights):
        d = (_normalize_tensor(fx) - _normalize_tensor(fy)) ** 2
        total = total + torch.sum(d * w.reshape(1, -1, 1, 1), dim=1).mean(dim=(1, 2))
    return total


def load_weights(path: str) -> Dict[str, object]:
    """{"features": the trunk's state dict, "lins": 5 head weights [C_l]}
    from the JAX package's ``.npz`` (``conv{i}_kernel`` HWIO,
    ``conv{i}_bias``, ``lin{i}``) or a directory with ``alexnet.pth`` and
    ``lpips_alex.pth`` (whose heads enter as |w|)."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            sd, lins = {}, []
            for i, ti in enumerate(_TORCH_IDX):
                kernel = np.asarray(d[f"conv{i}_kernel"], np.float32)
                sd[f"features.{ti}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
                sd[f"features.{ti}.bias"] = torch.from_numpy(
                    np.asarray(d[f"conv{i}_bias"], np.float32))
                lins.append(torch.from_numpy(np.asarray(d[f"lin{i}"], np.float32)))
        return {"features": sd, "lins": lins}

    alex_sd = torch.load(os.path.join(path, "alexnet.pth"),
                         map_location="cpu", weights_only=True)
    lin_sd = torch.load(os.path.join(path, "lpips_alex.pth"),
                        map_location="cpu", weights_only=True)
    sd = {f"features.{ti}.{k}": alex_sd[f"features.{ti}.{k}"]
          for ti in _TORCH_IDX for k in ("weight", "bias")}
    lins = [lin_sd[f"lin{i}.model.1.weight"].reshape(-1).abs()
            for i in range(len(_TORCH_IDX))]
    return {"features": sd, "lins": lins}


def create_lpips(weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """Returns lpips(x, y) over [B,H,W,3] images in [0,1] → [B] on
    ``device``, or None when no weights are available (callers skip the
    metric, as the reference does)."""
    if weights_path is None:
        return None
    try:
        weights = load_weights(weights_path)
    except (OSError, KeyError, RuntimeError) as e:
        print(f"LPIPS weights unavailable ({e}); skipping metric")
        return None

    dev = resolve_device(device)
    model = AlexNetFeatures()
    model.load_state_dict(weights["features"])
    model.to(dev).eval()
    lins = [w.to(dev) for w in weights["lins"]]
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)

    def prep(img: torch.Tensor) -> torch.Tensor:
        return (2.0 * img - 1.0 - shift) / scale

    @torch.no_grad()
    def lpips(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lpips_distance(model(prep(x)), model(prep(y)), lins)

    return lpips
