"""Train and eval steps and checkpoints (counterpart of
``pose_splatter_tpu/train/loop.py``).

A frame batch is a leading axis of size B. As the JAX step vmaps its
forward over the frames, each frame here runs its own forward with its own
BN batch statistics, all from the same old running statistics; the loss,
the metrics and the new running statistics are averaged over the frames.

Checkpoints hold the JAX package's payload keys {step, params,
batch_stats, opt_state} and a ``.meta.json`` beside them, written with
``torch.save``. They are not Orbax checkpoints: the two packages cannot
load each other's files.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from pose_splatter_torch.train.losses import total_loss
from pose_splatter_torch.utils import stages


class TrainState(NamedTuple):
    step: int
    model: torch.nn.Module  # a PoseSplatter; its ``net`` holds the weights
    optimizer: torch.optim.Optimizer


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 added outside the
    square root, no weight decay; the same update formula."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model, lr: float) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=adam(model.net.parameters(), lr))


def _forward_loss(model, frame: Dict, img_lambda: float, ssim_lambda: float,
                  train: bool):
    """Forward + loss for one frame (``loop.py:48-73``): renders
    ``frame["view_idx"]`` and compares it with observed view
    ``frame["obs_idx"]``. The count of Gaussian×tile instances dropped by
    finite binning capacity rides along in the metrics (zero in healthy
    runs). Returns the loss, the metrics and, in train mode, the new
    running statistics."""
    mask = model._tensor(frame["mask"])
    img = model._tensor(frame["img"])
    args = (mask, img, frame["p_3d"], frame["angle"], frame["view_idx"])
    if train:
        rgb, alpha, new_stats, overflow = model(*args, train=True)
    else:
        rgb, alpha, overflow = model(*args, return_overflow=True)
        new_stats = None
    obs = int(frame["obs_idx"])
    loss, metrics = total_loss(rgb[0], alpha[0], img[obs], mask[obs],
                               img_lambda, ssim_lambda)
    return loss, dict(metrics, overflow=overflow.float()), new_stats


def _frames(batch: Dict):
    return [{k: v[b] for k, v in batch.items()}
            for b in range(len(batch["angle"]))]


def _mean(metrics):
    return {k: torch.stack([m[k].detach() for m in metrics]).mean()
            for k in metrics[0]}


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    img_lambda: float, ssim_lambda: float,
                    batch_size: int = 1
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Train step over a frame batch (``loop.py:76-120``).

    Batch entries carry a leading frame axis of size ``batch_size``:
    mask [B,C',H,W], img [B,C',H,W,3], p_3d [B,3], angle [B], view_idx [B],
    obs_idx [B]. Each frame's forward, loss and new BN statistics come from
    the same old statistics; then the gradient of the mean loss, one
    optimizer step, and the running statistics set to the frames' mean.
    Returns the new state and the metrics meaned over the frames.

    Each frame's backward runs right after its forward (of loss / B, the
    gradients adding up to the gradient of the mean), so one frame's graph
    is alive at a time. Parameters whose gradient stays None (the bodies of
    the intermediate U-Nets, whose output never reaches the loss) are left
    alone by the optimizer, as optax leaves a zero gradient with zero
    moments.
    """

    def train_step(state: TrainState, batch: Dict):
        frames = _frames(batch)
        if len(frames) != batch_size:
            raise ValueError(f"batch of {len(frames)} frames, expected {batch_size}")
        stages.mark("data")
        optimizer.zero_grad(set_to_none=True)
        metrics, stats = [], []
        for frame in frames:
            loss, m, new_stats = _forward_loss(model, frame, img_lambda,
                                               ssim_lambda, train=True)
            stages.mark("loss", loss)
            (loss / len(frames)).backward()
            stages.mark("backward")
            metrics.append(m)
            stats.append(new_stats)
        optimizer.step()
        with torch.no_grad():
            buffers = dict(model.net.named_buffers())
            for name in stats[0]:
                buffers[name].copy_(torch.stack([s[name] for s in stats]).mean(0))
        mean = _mean(metrics)
        stages.mark("optimizer", mean)
        return state._replace(step=state.step + 1), mean

    return train_step


def make_eval_step(model, img_lambda: float, ssim_lambda: float
                   ) -> Callable[[Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Validation-loss step over a frame batch (``loop.py:205-226``), with
    the model's running BN statistics.

    Batch entries carry a leading frame axis B: mask [B,C',H,W],
    img [B,C',H,W,3], p_3d [B,3], angle [B], view_idx [B], obs_idx [B].
    Returns the loss and the metrics, each meaned over the frames.
    """

    @torch.no_grad()
    def eval_step(batch: Dict):
        losses, metrics = [], []
        for frame in _frames(batch):
            loss, m, _ = _forward_loss(model, frame, img_lambda, ssim_lambda,
                                       train=False)
            losses.append(loss)
            metrics.append(m)
        return torch.stack(losses).mean(), _mean(metrics)

    return eval_step


# ----------------------------------------------------------------------------
# Checkpoints (torch.save; not cross-loadable with the JAX package's Orbax).
# ----------------------------------------------------------------------------

def save_checkpoint(path: str, state: TrainState, extra: Optional[Dict] = None):
    """Save {step, params, batch_stats, opt_state} to ``path`` and any
    JSON-serialisable ``extra`` (loss history etc.) to ``path.meta.json``."""
    net = state.model.net
    payload = {
        "step": state.step,
        "params": {k: v.detach().cpu() for k, v in net.named_parameters()},
        "batch_stats": {k: v.detach().cpu() for k, v in net.named_buffers()},
        "opt_state": state.optimizer.state_dict(),
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path)
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint into ``state``'s model and optimizer (in place)
    and return the state with the saved step, and the ``extra`` dict."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.net.load_state_dict({**payload["params"],
                                     **payload["batch_stats"]})
    state.optimizer.load_state_dict(payload["opt_state"])
    extra = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return state._replace(step=int(payload["step"])), extra
