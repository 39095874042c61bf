"""Checkpoints across the two packages: the port's payload ↔ the JAX
package's payload as a numpy tree.

The port's checkpoint (``train/loop.py``) is a ``torch.save`` payload
{step, params, batch_stats, opt_state} with ``torch.optim.Adam``'s
``state_dict`` as ``opt_state``. The JAX package's
(``pose_splatter_tpu/train/loop.py:233-280``) is an Orbax checkpoint of
{step, params, batch_stats, opt_state} with Flax trees and optax.adam's
state ``(ScaleByAdamState(count, mu, nu), EmptyState())``. This module
converts between the port's payload and that JAX payload held as numpy
leaves (what ``jax.tree.map(np.asarray, payload)`` gives), and writes and
reads the port's file from such a tree. It imports neither jax nor orbax:
loading orbax loads jax. The Orbax files are written and read by the JAX
package's own ``save_checkpoint`` / ``load_checkpoint``, where JAX is
installed.

- Weights go through the bridge (``bridge.py``), and Adam's ``mu`` /
  ``nu`` (torch's ``exp_avg`` / ``exp_avg_sq``) take the same layout
  changes. Every leaf crosses bit for bit, both ways.
- optax keeps one ``count``; torch keeps a ``step`` for every parameter it
  has updated. The parameters of the intermediate U-Nets get no gradient
  in the port (their input passthrough replaces their whole output, so
  ``train/loop.py`` leaves their gradient None) and so no torch state;
  optax holds zero ``mu`` and ``nu`` for them. So a parameter without
  torch state becomes zeros, and after a first step every parameter
  outside those U-Nets gets torch state, its moments zero or not (a layer
  that sees one voxel, say, gets exactly zero gradients in both packages).
- The ``.meta.json`` beside either checkpoint (``epoch``, ``losses`` …)
  crosses as it is.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pose_splatter_torch.bridge import variables_from_flax, variables_to_flax
from pose_splatter_torch.models.unet3d import Unet3D
from pose_splatter_torch.train.loop import (
    TrainState,
    read_checkpoint,
    write_checkpoint,
)


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``, its fields in its order."""
    count: np.ndarray  # [] int32
    mu: Dict
    nu: Dict


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (``scale_by_learning_rate`` keeps none)."""


def _adam_count(opt_state: Dict) -> int:
    steps = {float(s["step"]) for s in opt_state["state"].values()}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters have taken different step "
                         f"counts {sorted(steps)}; optax keeps one count")
    return int(steps.pop()) if steps else 0


def to_jax_tree(payload: Dict) -> Dict[str, Any]:
    """The port's checkpoint payload → the JAX payload as a numpy tree:
    {step [] int32, params, batch_stats, opt_state=(ScaleByAdamState(count
    [] int32, mu, nu), EmptyState())}."""
    params, stats = payload["params"], payload["batch_stats"]
    tree = variables_to_flax({**params, **stats})
    opt = payload["opt_state"]
    names = list(params)
    ids = [i for g in opt["param_groups"] for i in g["params"]]
    if len(ids) != len(names):
        raise ValueError(f"Adam holds {len(ids)} parameters, the payload "
                         f"{len(names)}")
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        sd = {}
        for i, name in zip(ids, names):
            s = opt["state"].get(i)
            sd[name] = (s[key] if s is not None
                        else torch.zeros_like(params[name]))
        moments.append(variables_to_flax(sd)["params"])
    count = np.asarray(_adam_count(opt), np.int32)
    return {
        "step": np.asarray(payload["step"], np.int32),
        "params": tree["params"],
        "batch_stats": tree["batch_stats"],
        "opt_state": (ScaleByAdamState(count, *moments), EmptyState()),
    }


def from_jax_tree(tree: Dict[str, Any], state: TrainState) -> Dict:
    """The JAX payload as a numpy tree → the port's checkpoint payload for
    ``state`` (a :class:`TrainState` of the model and Adam it will be loaded
    into: the parameter order and Adam's ``param_groups`` come from there;
    the values all come from ``tree``)."""
    adam_state = tree["opt_state"][0]
    count, mu, nu = adam_state.count, adam_state.mu, adam_state.nu
    stats = tree["batch_stats"]
    sd = variables_from_flax({"params": tree["params"], "batch_stats": stats})
    sd_mu = variables_from_flax({"params": mu, "batch_stats": stats})
    sd_nu = variables_from_flax({"params": nu, "batch_stats": stats})
    net = state.model.net
    params = [k for k, _ in net.named_parameters()]
    buffers = [k for k, _ in net.named_buffers()]
    if set(sd) != set(params) | set(buffers):
        raise KeyError(f"the tree's entries do not match the model's: "
                       f"{sorted(set(sd) ^ (set(params) | set(buffers)))[:5]}")
    groups = state.optimizer.state_dict()["param_groups"]
    ids = [i for g in groups for i in g["params"]]
    passthrough = tuple(f"{n}." for n, m in net.named_modules()
                        if isinstance(m, Unet3D)
                        and m.in_channels == m.out_channels)
    adam = {}
    for i, name in zip(ids, params):
        if int(count) > 0 and not name.startswith(passthrough):
            adam[i] = {"step": torch.tensor(float(count)),
                       "exp_avg": sd_mu[name], "exp_avg_sq": sd_nu[name]}
    return {
        "step": int(tree["step"]),
        "params": {k: sd[k] for k in params},
        "batch_stats": {k: sd[k] for k in buffers},
        "opt_state": {"state": adam, "param_groups": groups},
    }


def save_jax_tree(path: str, tree: Dict[str, Any], state: TrainState,
                  extra: Optional[Dict] = None) -> None:
    """Write the port's checkpoint at ``path`` (and ``extra`` beside it)
    from a JAX payload tree, for ``state``'s model and optimizer; the
    port's ``load_checkpoint`` reads it."""
    write_checkpoint(path, from_jax_tree(tree, state), extra)


def load_jax_tree(path: str) -> Tuple[Dict[str, Any], Dict]:
    """Read the port's checkpoint at ``path`` as a JAX payload tree, and
    its ``extra`` dict."""
    payload, extra = read_checkpoint(path)
    return to_jax_tree(payload), extra
