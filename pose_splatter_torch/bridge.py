"""Flax ↔ PyTorch weight bridge for ``PoseSplatterNet``.

``variables_from_flax`` takes the JAX package's ``{'params',
'batch_stats'}`` tree with numpy leaves (e.g. ``jax.tree.map(np.asarray,
variables)``) and returns a state dict for
:class:`pose_splatter_torch.models.pose_splatter.PoseSplatterNet`;
``variables_to_flax`` is its exact inverse (every leaf bit for bit, both
ways). Neither imports jax or flax. ``nn.remat`` keeps the Flax module
names, so one bridge serves models with and without ``remat_unets``.

- Conv kernels ``[kd,kh,kw,in,out]`` → ``[out,in,kd,kh,kw]``.
- ``nn.ConvTranspose`` (no ``transpose_kernel``) convolves the dilated
  input with the kernel as stored, where ``torch.nn.ConvTranspose3d``
  scatters it, so the kernel is flipped in space as well:
  ``[kd,kh,kw,in,out]`` → ``[in,out,kd,kh,kw]`` reversed on kd, kh, kw.
- Dense kernels ``[in,out]`` are transposed; the U-Net flattens its
  bottleneck in NDHWC order, so ``mlp_1a`` / ``mlp_2`` rows need nothing
  more.
- BatchNorm scale, bias, mean and var are copied as they are; ``scale``
  is copied.

``resnet_from_flax`` and ``alexnet_from_flax`` carry the auxiliary nets'
Flax weights (ResNet18, LPIPS's AlexNet trunk and heads) to the port's
modules, 2D kernels ``[kh,kw,in,out]`` → ``[out,in,kh,kw]``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv(p: Mapping, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (4, 3, 0, 1, 2)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(p: Mapping, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1, ::-1]
    sd[f"{prefix}.weight"] = _t(np.transpose(k, (3, 4, 0, 1, 2)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(p: Mapping, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _batch_norm(p: Mapping, s: Mapping, prefix: str,
                sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])


def _unet(p: Mapping, s: Mapping, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    for name, layer in p.items():
        pre = f"{prefix}.{name}"
        if name.startswith(("encoder", "decoder")):
            for i in (0, 1):
                _conv(layer[f"conv{i}"], f"{pre}.conv{i}", sd)
                _batch_norm(layer[f"bn{i}"], s[name][f"bn{i}"], f"{pre}.bn{i}", sd)
        elif name.startswith("upconv"):
            _conv_transpose(layer, pre, sd)
        elif name == "final_conv":
            _conv(layer, pre, sd)
        elif name.startswith("mlp"):
            _dense(layer, pre, sd)
        else:
            raise KeyError(f"unexpected U-Net layer {name!r}")


def variables_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``PoseSplatterNet`` variables (numpy leaves) → torch state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "scale":
            sd["scale"] = _t(sub)
        elif name in ("head1", "head2"):
            _dense(sub, name, sd)
        elif name.startswith("unet_"):
            _unet(sub, stats[name], f"unets.{int(name[5:])}", sd)
        elif name == "final_unet":
            _unet(sub, stats[name], "final_unet", sd)
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return sd


# ----------------------------------------------------------------------------
# The inverse: torch state dict → Flax numpy tree.
# ----------------------------------------------------------------------------

def _n(x) -> np.ndarray:
    return np.ascontiguousarray(torch.as_tensor(x).detach().cpu().numpy())


def _set(tree: Dict, path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def variables_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """Torch ``PoseSplatterNet`` state dict → Flax ``{'params',
    'batch_stats'}`` with numpy float32 leaves: the exact inverse of
    :func:`variables_from_flax`.

    Conv weights ``[out,in,kd,kh,kw]`` → ``[kd,kh,kw,in,out]``; transpose-
    conv weights ``[in,out,kd,kh,kw]`` → ``[kd,kh,kw,in,out]`` flipped back
    in space; dense weights transposed; BatchNorm weight / bias / running
    mean / running variance → scale / bias / mean / var. A state dict that
    holds only some entries (Adam's moments of the parameters, say) gives
    the tree of those entries.
    """
    params: Dict = {}
    stats: Dict = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        if parts[0] == "unets":
            parts = [f"unet_{parts[1]}"] + parts[2:]
        *path, leaf = parts
        x = _n(value)
        if leaf in ("running_mean", "running_var"):
            _set(stats, path + [{"running_mean": "mean",
                                 "running_var": "var"}[leaf]], x)
        elif len(path) >= 2 and path[-1].startswith("bn"):
            _set(params, path + [{"weight": "scale", "bias": "bias"}[leaf]], x)
        elif leaf == "bias":
            _set(params, path + ["bias"], x)
        elif name == "scale":
            params["scale"] = x
        elif x.ndim == 5 and path[-1].startswith("upconv"):
            k = np.transpose(x, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]
            _set(params, path + ["kernel"], np.ascontiguousarray(k))
        elif x.ndim == 5:
            _set(params, path + ["kernel"],
                 np.ascontiguousarray(np.transpose(x, (2, 3, 4, 1, 0))))
        elif x.ndim == 2:
            _set(params, path + ["kernel"], np.ascontiguousarray(x.T))
        else:
            raise KeyError(f"unexpected state-dict entry {name!r}")
    return {"params": params, "batch_stats": stats}


# ----------------------------------------------------------------------------
# The auxiliary nets: ResNet-18 and LPIPS's AlexNet trunk.
# ----------------------------------------------------------------------------

def _conv2d(kernel, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    """A Flax 2D conv kernel [kh,kw,in,out] → torch [out,in,kh,kw]."""
    sd[f"{prefix}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))


def resnet_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax ``ResNet18`` variables (numpy leaves) → a
    state dict of :class:`pose_splatter_torch.models.resnet.ResNet18` in
    torchvision's key layout (``layer{s}_{b}/downsample_conv`` →
    ``layer{s}.{b}.downsample.0``, ``downsample_bn`` → ``.1``)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(p, s, prefix):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])

    for name, sub in params.items():
        if name == "conv1":
            _conv2d(sub["kernel"], "conv1", sd)
        elif name == "bn1":
            bn(sub, stats["bn1"], "bn1")
        elif name.startswith("layer"):
            stage, block = name[5:].split("_")
            pre = f"layer{stage}.{block}"
            for layer, p in sub.items():
                torch_name = {"downsample_conv": "downsample.0",
                              "downsample_bn": "downsample.1"}.get(layer, layer)
                if "kernel" in p:
                    _conv2d(p["kernel"], f"{pre}.{torch_name}", sd)
                else:
                    bn(p, stats[name][layer], f"{pre}.{torch_name}")
        else:
            raise KeyError(f"unexpected ResNet18 parameter group {name!r}")
    return sd


def alexnet_from_flax(params: Mapping[str, Any], lins) -> Dict[str, Any]:
    """The JAX package's LPIPS weights (``load_weights``' ``params`` of
    ``AlexNetFeatures``, ``conv{i}``, and its 5 ``lins``) → the port's
    ``ops/lpips.py::load_weights`` form: {"features": the trunk's state
    dict under torchvision's ``features.{0,3,6,8,10}`` names, "lins": 5
    tensors}."""
    sd: Dict[str, torch.Tensor] = {}
    for i, ti in enumerate((0, 3, 6, 8, 10)):
        _conv2d(params[f"conv{i}"]["kernel"], f"features.{ti}", sd)
        sd[f"features.{ti}.bias"] = _t(params[f"conv{i}"]["bias"])
    return {"features": sd, "lins": [_t(w) for w in lins]}
