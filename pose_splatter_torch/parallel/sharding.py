"""Data-parallel training over frame batches (counterpart of
``pose_splatter_tpu/parallel/sharding.py``).

The JAX package annotates its batched step with shardings and lets XLA
insert the gradient all-reduce. Here every rank of the mesh's ``data``
axis runs the port's train step (``train/loop.py``) on its own frames and
averages over the axis, in one flat bucket each: the gradients before the
update, then the new BN running statistics and the metrics. So the
gradient is the global batch's, the running statistics are the mean of
every frame's update (ROADMAP C.2: not rank 0's, which DDP's
``broadcast_buffers`` would copy), ``total`` is the global batch's mean on
every rank, and every rank takes the same Adam step. DDP is not used: its
search for unused parameters and its buffer broadcast break those rules.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple

import torch

from pose_splatter_torch.parallel.comm import broadcast_, mean_over
from pose_splatter_torch.parallel.mesh import Mesh
from pose_splatter_torch.train.loop import TrainState, _frames, _step


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Copy the mesh's first rank's parameters, buffers and optimizer state
    (Adam's moments and step counts, which a capturable Adam keeps on the
    device) to every rank of the mesh, in place."""
    net = state.model.net
    tensors = list(net.parameters()) + list(net.buffers())
    for p in net.parameters():
        tensors += [v for v in state.optimizer.state.get(p, {}).values()
                    if torch.is_tensor(v)]
    broadcast_(tensors, mesh)
    return state


def shard_batch(batch: Dict, mesh: Mesh, batch_axis: str = "data") -> Dict:
    """This rank's block of the batch's leading axis: rank i of the axis
    takes frames [i·B/n, (i+1)·B/n), as ``PartitionSpec(batch_axis)``
    places them."""
    n = mesh.shape[batch_axis]
    i = mesh.index(batch_axis)
    out = {}
    for k, v in batch.items():
        if len(v) % n:
            raise ValueError(f"batch of {len(v)} frames does not split over "
                             f"{n} ranks")
        b = len(v) // n
        out[k] = v[i * b:(i + 1) * b]
    return out


def make_sharded_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    img_lambda: float,
    ssim_lambda: float,
    mesh: Mesh,
    batch_axis: str = "data",
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Data-parallel train step over ``mesh[batch_axis]``: ``step(state,
    local_batch)`` with this rank's frames (:func:`shard_batch`), the
    global batch a multiple of the axis size. Returns the new state and the
    metrics meaned over the global batch, the same on every rank.

    Parameters whose gradient stays None (the intermediate U-Nets' bodies,
    ``train/loop.py``) are out of the bucket on every rank alike: which
    ones is fixed by the model, not by the data."""
    reduce = partial(mean_over, mesh=mesh, axis=batch_axis)

    def step(state: TrainState, batch: Dict):
        mean = _step(model, optimizer, _frames(batch), img_lambda,
                     ssim_lambda, mean_over=reduce)
        model.check_selection()
        return state._replace(step=state.step + 1), mean

    return step
