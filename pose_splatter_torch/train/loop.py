"""Train and eval steps, K train steps a call (a captured CUDA graph on
the card), and checkpoints (counterpart of
``pose_splatter_tpu/train/loop.py``).

A frame batch is a leading axis of size B. As the JAX step vmaps its
forward over the frames, each frame here runs its own forward with its own
BN batch statistics, all from the same old running statistics; the loss,
the metrics and the new running statistics are averaged over the frames.

Checkpoints hold the JAX package's payload keys {step, params,
batch_stats, opt_state} and a ``.meta.json`` beside them, written with
``torch.save``. They are not Orbax checkpoints; ``train/checkpoint_convert.py``
converts them to and from the JAX package's payload as a numpy tree, which
that package's own ``save_checkpoint`` / ``load_checkpoint`` write and read.
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


# The metrics of a train step, in the order MultiStep stacks them.
METRICS = ("iou", "ssim", "img", "total", "overflow")
# Eager steps before a MultiStep captures its step: they build what the
# capture reads (Adam's state, the selection's table, the kernels,
# cuDNN's choices), as in PyTorch's whole-network capture.
WARMUP_STEPS = 3
# Root spans of a train step and of a K-step call (``utils/stages.py``).
_STEP = stages.Scope("step")
_MULTI_STEP = stages.Scope("multi_step")


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 added outside the
    square root, no weight decay; the same update formula.

    On CUDA parameters it is built with ``capturable=True``: the step count
    stays on the device, so a CUDA graph can hold the update. It then takes
    the bias corrections in float32 on the device, where the eager
    optimizer takes them from the host in float64."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=any(p.is_cuda for p in params))


def create_train_state(model, lr: float) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=adam(model.net.parameters(), lr))


def _forward_loss(model, frame: Dict, img_lambda: float, ssim_lambda: float,
                  train: bool):
    """Forward + loss for one frame (``loop.py:48-73``): renders
    ``frame["view_idx"]`` and compares it with observed view
    ``frame["obs_idx"]``, selected by an index on the frame's device (no
    read-back). An adaptive frame's ``K_mask`` and ``seed_3d`` (the
    loader's host hook) go to the forward as ``K_mask`` and
    ``carve_center``. The count of Gaussian×tile instances dropped by
    finite binning capacity rides along in the metrics (zero in healthy
    runs). Returns the loss, the metrics and, in train mode, the new
    running statistics."""
    mask = model._tensor(frame["mask"])
    img = model._tensor(frame["img"])
    args = (mask, img, frame["p_3d"], frame["angle"], frame["view_idx"])
    adaptive = dict(K_mask=frame.get("K_mask"),
                    carve_center=frame.get("seed_3d"))
    if train:
        rgb, alpha, new_stats, overflow = model(*args, train=True, **adaptive)
    else:
        rgb, alpha, overflow = model(*args, return_overflow=True, **adaptive)
        new_stats = None
    stages.begin("loss")
    obs = stages.to_device(frame["obs_idx"], mask.device).reshape(1).long()
    loss, metrics = total_loss(rgb[0], alpha[0], img.index_select(0, obs)[0],
                               mask.index_select(0, obs)[0], img_lambda,
                               ssim_lambda)
    return loss, dict(metrics, overflow=overflow.float()), new_stats


def _frames(batch: Dict):
    return [{k: v[b] for k, v in batch.items()}
            for b in range(len(batch["angle"]))]


def _mean(metrics):
    return {k: torch.stack([m[k].detach() for m in metrics]).mean()
            for k in metrics[0]}


def _step(model, optimizer, frames, img_lambda: float, ssim_lambda: float,
          mean_over: Optional[Callable] = None):
    """One optimizer step over ``frames`` (frame dicts): each frame's
    forward, loss and backward (of loss / B) from the same old BN
    statistics, one Adam step, the running statistics set to the frames'
    mean. Returns the metrics meaned over the frames. No read-back: a CUDA
    graph can capture it (with the gradients None before the capture).

    ``mean_over(tensors) -> tensors`` averages over the other ranks of a
    data-parallel step (``parallel/sharding.py``): the gradients before
    the update, then the new statistics and the metrics."""
    stages.mark("data")
    optimizer.zero_grad(set_to_none=True)
    metrics, stats = [], []
    for frame in frames:
        loss, m, new_stats = _forward_loss(model, frame, img_lambda,
                                           ssim_lambda, train=True)
        # The compositor's backward (kernel mode) ends "loss_bwd" and runs
        # "kernel_bwd" and "backward"; other modes have no such boundary.
        stages.end("loss", loss, then="loss_bwd"
                   if model.render_mode == "kernel" else "backward")
        (loss / len(frames)).backward()
        stages.end("backward")
        metrics.append(m)
        stats.append(new_stats)
    stages.begin("optimizer")
    if mean_over is not None:
        # Parameters whose gradient stays None are left out on every rank.
        grads = [p.grad for p in model.net.parameters() if p.grad is not None]
        for g, m in zip(grads, mean_over(grads)):
            g.copy_(m)
    optimizer.step()
    mean = _mean(metrics)
    with torch.no_grad():
        new = {name: torch.stack([s[name] for s in stats]).mean(0)
               for name in stats[0]}
        if mean_over is not None:
            keys = list(new) + list(mean)
            both = dict(zip(keys, mean_over([new[k] for k in new]
                                            + [mean[k] for k in mean])))
            new = {k: both[k] for k in new}
            mean = {k: both[k] for k in mean}
        buffers = dict(model.net.named_buffers())
        for name, value in new.items():
            buffers[name].copy_(value)
    stages.end("optimizer", mean)
    return mean


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
    Returns the new state and the metrics meaned over the frames; the
    selection's table flag is checked once a step.

    Each frame's backward runs right after its forward (of loss / B, the
    gradients adding up to the gradient of the mean), so one frame's graph
    is alive at a time. Parameters whose gradient stays None (the bodies of
    the intermediate U-Nets, whose output never reaches the loss) are left
    alone by the optimizer, as optax leaves a zero gradient with zero
    moments.
    """

    def train_step(state: TrainState, batch: Dict):
        with _STEP:
            frames = _frames(batch)
            if len(frames) != batch_size:
                raise ValueError(f"batch of {len(frames)} frames, "
                                 f"expected {batch_size}")
            mean = _step(model, optimizer, frames, img_lambda, ssim_lambda)
            model.check_selection()
        return state._replace(step=state.step + 1), mean

    return train_step


class MultiStep:
    """K train steps a call over device-resident frames: the counterpart of
    ``make_train_multi_step`` (``loop.py:123-202``), built by
    :func:`make_train_multi_step`.

    ``multi_step(state, frame_idx [K], view_idx [K], obs_idx [K])`` runs K
    single-frame train steps (each as :func:`make_train_step` with batch 1)
    and returns the state with ``step + K`` and the metrics of the last
    step; ``step_metrics`` holds every step's metrics ([K] each) of the
    last call. Each step gathers its frame from the stack by a device
    index: no frame data crosses from the host.

    On a CUDA device the first ``WARMUP_STEPS`` steps (real steps, on a
    side stream) run eagerly; then one step is captured as a
    ``torch.cuda.CUDAGraph`` and every later step is a replay of it, its
    indices copied on the device into the graph's index tensor. A call
    copies its K index triples to the device once, enqueues its replays
    and reads the device once, for the selection's table flag, before it
    returns. One graph of one step, replayed K times, serves any K, is
    captured once and holds one step's memory; the replays' launch cost is
    microseconds against a step of tens of ms. A capture that fails raises:
    there is no eager fallback. Launch counters count a kernel once at
    capture, so ``graph_launches`` keeps the compositor launches one replay
    makes and ``replays`` the replays made.

    On the CPU the K steps run as a plain loop.
    """

    def __init__(self, model, optimizer, img_lambda: float,
                 ssim_lambda: float, frames: Dict, steps_per_call: int = 8):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call {steps_per_call} < 1")
        dev = model.device
        self.model, self.optimizer = model, optimizer
        self.loss_args = (img_lambda, ssim_lambda)
        self.steps_per_call = steps_per_call
        self.frames = {k: torch.as_tensor(frames[k], dtype=torch.float32,
                                          device=dev).contiguous()
                       for k in ("mask", "img", "p_3d", "angle")}
        self.warmup_left = WARMUP_STEPS
        self.static_idx = torch.zeros(3, dtype=torch.long, device=dev)
        self.static_metrics: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: Dict[str, int] = {}
        self.replays = 0
        self.step_metrics: Dict[str, torch.Tensor] = {}

    def _one(self, idx: torch.Tensor) -> torch.Tensor:
        """One train step on frame idx[0], view idx[1], target idx[2];
        returns its metrics stacked in ``METRICS`` order."""
        frame = {k: v.index_select(0, idx[:1])[0]
                 for k, v in self.frames.items()}
        frame.update(view_idx=idx[1], obs_idx=idx[2])
        m = _step(self.model, self.optimizer, [frame], *self.loss_args)
        return torch.stack([m[k] for k in METRICS])

    def _capture(self):
        from pose_splatter_torch.ops import rasterize_kernels as RK

        kernels = dict(composite_fwd=RK.composite_instances,
                       composite_bwd=RK.composite_instances_bwd)
        before = {k: f.launches for k, f in kernels.items()}
        torch.cuda.synchronize(self.model.device)
        # Gradients None before the capture: the captured backward then
        # writes them afresh (graph memory) on every replay.
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_metrics = self._one(self.static_idx)
        self.graph = graph
        self.graph_launches = {k: f.launches - before[k]
                               for k, f in kernels.items()}

    def __call__(self, state: TrainState, frame_idx, view_idx, obs_idx):
        if stages.recording():
            raise RuntimeError(
                "multi_step cannot run inside stages.record(): every mark "
                "synchronises, which a captured step cannot do")
        with _MULTI_STEP:
            K = self.steps_per_call
            dev = self.model.device
            idx = torch.stack([torch.as_tensor(x).reshape(-1).long()
                               for x in (frame_idx, view_idx, obs_idx)], 1)
            if idx.shape != (K, 3):
                raise ValueError(f"expected {K} steps' indices, "
                                 f"got {idx.shape[0]}")
            idx = stages.to_device(idx, dev)  # one copy of the K index triples
            hist = torch.empty((K, len(METRICS)), dtype=torch.float32,
                               device=dev)
            k = 0
            if dev.type != "cuda":
                for k in range(K):
                    hist[k] = self._one(idx[k])
            else:
                if self.graph is None:
                    main = torch.cuda.current_stream(dev)
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(main)
                    with torch.cuda.stream(side):
                        while k < K and self.warmup_left > 0:
                            hist[k] = self._one(idx[k])
                            k += 1
                            self.warmup_left -= 1
                    main.wait_stream(side)
                    if self.warmup_left == 0:
                        self._capture()
                for k in range(k, K):
                    self.static_idx.copy_(idx[k])
                    self.graph.replay()
                    hist[k].copy_(self.static_metrics)
                    self.replays += 1
            self.model.check_selection()
            self.step_metrics = {n: hist[:, i] for i, n in enumerate(METRICS)}
            return (state._replace(step=state.step + K),
                    {n: hist[-1, i] for i, n in enumerate(METRICS)})


def make_train_multi_step(model, optimizer: torch.optim.Optimizer,
                          img_lambda: float, ssim_lambda: float,
                          frames: Dict, steps_per_call: int = 8) -> MultiStep:
    """K train steps a call (``loop.py:123-202``): ``frames`` holds the
    stacked frames, mask [T,C',H,W], img [T,C',H,W,3], p_3d [T,3],
    angle [T] (numpy or tensors), moved to the model's device once. See
    :class:`MultiStep`."""
    return MultiStep(model, optimizer, img_lambda, ssim_lambda, frames,
                     steps_per_call)


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
# Checkpoints (torch.save; see train/checkpoint_convert.py for the JAX payload).
# ----------------------------------------------------------------------------

def checkpoint_payload(state: TrainState) -> Dict:
    """The checkpoint payload of ``state``: {step, params, batch_stats,
    opt_state}, the net's parameters and buffers on the CPU in their
    ``named_parameters`` / ``named_buffers`` order (the optimizer's
    parameter indices follow the same order) and Adam's ``state_dict``."""
    net = state.model.net
    return {
        "step": state.step,
        "params": {k: v.detach().cpu() for k, v in net.named_parameters()},
        "batch_stats": {k: v.detach().cpu() for k, v in net.named_buffers()},
        "opt_state": state.optimizer.state_dict(),
    }


def write_checkpoint(path: str, payload: Dict, extra: Optional[Dict] = None):
    """``torch.save`` a payload to ``path`` and any JSON-serialisable
    ``extra`` (loss history etc.) to ``path.meta.json``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path)
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)


def read_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """The payload at ``path`` (on the CPU) and its ``extra`` dict."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    extra = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return payload, extra


def save_checkpoint(path: str, state: TrainState, extra: Optional[Dict] = None):
    """Save {step, params, batch_stats, opt_state} to ``path`` and any
    JSON-serialisable ``extra`` (loss history etc.) to ``path.meta.json``."""
    write_checkpoint(path, checkpoint_payload(state), extra)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint into ``state``'s model and optimizer (in place)
    and return the state with the saved step, and the ``extra`` dict."""
    payload, extra = read_checkpoint(path)
    state.model.net.load_state_dict({**payload["params"],
                                     **payload["batch_stats"]})
    state.optimizer.load_state_dict(payload["opt_state"])
    return state._replace(step=int(payload["step"])), extra
