"""Config-driven training (counterpart of
``pose_splatter_tpu/train/trainer.py``): ``build_model`` and
``train_from_config``, the reference's ``train_script.py`` loop over the
train step: per-epoch training over shuffled frames, validation every
``valid_every`` epochs, checkpoints every ``save_every``, ``load`` to resume.

Not ported yet: the plots (the JAX trainer skips them when their import
fails; here they are always skipped until viz is ported), ``remat_unets``
and ``adaptive_camera`` (both raise).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pose_splatter_torch.config import Config
from pose_splatter_torch.data.dataset import FrameDataset, FrameLoader
from pose_splatter_torch.models.pose_splatter import (
    PoseSplatter,
    init_means2d_center,
)
from pose_splatter_torch.models.unet3d import init_unet_primary_skip
from pose_splatter_torch.train.loop import (
    create_train_state,
    load_checkpoint,
    make_eval_step,
    make_train_step,
    save_checkpoint,
)
from pose_splatter_torch.utils.cameras import get_cam_params

LOSS_NAMES = ("iou", "ssim", "img")


def build_model(
    config: Config,
    ablation: bool = False,
    render_mode: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    cameras: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    seed: int = 0,
) -> PoseSplatter:
    """Build the model a config describes, on ``device``.

    ``render_mode`` defaults to the config's ``render_mode`` or
    ``"kernel"``: the hand-written compositor on a CUDA device, its plain
    PyTorch version on the CPU (chosen by where the tensors lie; there is
    no fallback between the two). ``cameras`` = (intrinsics [C,3,3],
    extrinsics [C,4,4]) replaces loading ``config.camera_fn``.
    """
    if render_mode is None:
        render_mode = config.get("render_mode", "kernel")
    if cameras is None:
        intrinsic, extrinsic, _ = get_cam_params(
            config.camera_fn,
            ds=config.image_downsample,
            up_fn=config.vertical_lines_fn,
            auto_orient=True,
            load_up_direction=not config.adaptive_camera,
        )
    else:
        intrinsic, extrinsic = cameras
    if config.adaptive_camera:
        raise NotImplementedError("adaptive_camera is not ported yet")
    return PoseSplatter(
        intrinsics=intrinsic,
        extrinsics=extrinsic,
        W=config.render_width,
        H=config.render_height,
        ell=config.ell,
        grid_size=config.grid_size,
        volume_idx=config.validated_volume_idx(),
        ablation=ablation,
        volume_fill_color=config.volume_fill_color,
        holdout_views=config.holdout_views,
        gaussian_mode=config.gaussian_mode,
        gaussian_config=config.gaussian_config,
        render_mode=render_mode,
        min_n=config.get("min_n", 1024),
        max_n=config.get("max_n", 16000),
        num_unets=config.get("num_unets", 3),
        base_filters=config.get("base_filters", 8),
        device=device,
        seed=seed,
    )


def build_datasets(config: Config, splits=("train", "valid")):
    """The config's ``images.h5`` / ``center_rotation.npz`` as one
    :class:`FrameDataset` per split."""
    img_fn = os.path.join(config.image_directory, "images.h5")
    _, _, Ps = get_cam_params(
        config.camera_fn,
        ds=config.image_downsample,
        up_fn=config.vertical_lines_fn,
        auto_orient=True,
        load_up_direction=not config.adaptive_camera,
    )
    return [FrameDataset(img_fn, config.center_rotation_fn, len(Ps),
                         holdout_views=config.holdout_views, split=s,
                         max_frames=config.max_frames)
            for s in splits]


def checkpoint_path(config: Config, ablation: bool) -> str:
    fn = config.model_fn
    if fn.endswith(".pt"):
        fn = fn[:-3]
    return fn + ("_ablation.ckpt" if ablation else ".ckpt")


def train_from_config(
    config: Config,
    epochs: int = 50,
    load: bool = False,
    ablation: bool = False,
    max_batches: Optional[int] = None,
    batch_size: int = 1,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    cameras: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    datasets: Optional[Sequence] = None,
):
    """Run training (``trainer.py:114-249``); returns (state, losses,
    validation_losses).

    ``cameras`` = (intrinsics [C,3,3], extrinsics [C,4,4]) and ``datasets``
    = (train, valid) replace the config's camera and image files (any
    dataset with ``FrameDataset``'s interface, e.g.
    ``utils/synthetic.py::FrameSet``).

    A fresh start re-initialises the net with ``init_unet_primary_skip``
    (over every layer, the heads included, as the JAX trainer maps it over
    its whole parameter tree) and, in 2D mode, ``init_means2d_center``.
    Deviation: the JAX trainer calls ``init_means2d_center`` without
    ``anchored``, which in view-anchored mode offsets every Gaussian by
    (W/2, H/2) from its anchor; here ``anchored`` follows the model, as
    that function's own docstring and the JAX synthetic benchmark intend.
    """
    if config.get("remat_unets", False):
        raise NotImplementedError("remat_unets is not ported yet")
    if config.adaptive_camera:
        raise NotImplementedError("adaptive_camera is not ported yet")
    model = build_model(config, ablation=ablation, device=device,
                        cameras=cameras, seed=seed)
    train_ds, valid_ds = datasets if datasets is not None else build_datasets(config)
    loader = FrameLoader(train_ds, batch_size=batch_size, shuffle=True,
                         seed=seed)
    valid_loader = FrameLoader(valid_ds, batch_size=batch_size, shuffle=False,
                               seed=seed)

    state = create_train_state(model, config.lr)
    losses, validation_losses = [], []
    epoch = 0

    ckpt_fn = checkpoint_path(config, ablation)
    if load:
        state, extra = load_checkpoint(ckpt_fn, state)
        epoch = int(extra.get("epoch", 0))
        losses = list(extra.get("losses", []))
        validation_losses = list(extra.get("validation_losses", []))
        print(f"Loaded checkpoint from epoch {epoch}.")
    elif not ablation:
        # Fresh start: near-identity U-Net init (train_script.py:356-361).
        init_unet_primary_skip(model.net, in_channels=model.in_channels)
        if model.gaussian_mode == "2d":
            init_means2d_center(model.net, model.W, model.H,
                                anchored=model.view_anchored_2d)

    step_fn = make_train_step(model, state.optimizer,
                              img_lambda=config.img_lambda,
                              ssim_lambda=config.ssim_lambda,
                              batch_size=batch_size)
    eval_fn = make_eval_step(model, img_lambda=config.img_lambda,
                             ssim_lambda=config.ssim_lambda)

    for _ in range(epochs):
        epoch += 1
        # Metrics stay on the device; one host sync per epoch.
        epoch_metrics = []
        for b_num, batch in enumerate(loader):
            state, metrics = step_fn(state, batch)
            epoch_metrics.append(metrics)
            if max_batches and b_num + 1 >= max_batches:
                break
        if epoch_metrics:
            host = {k: torch.stack([m[k] for m in epoch_metrics]).cpu().numpy()
                    for k in epoch_metrics[0]}
            avg = [float(np.mean(host[k])) for k in LOSS_NAMES]
            # The step means the overflow over the frame batch; undo the
            # mean to report the epoch's total dropped-instance count.
            dropped = float(np.sum(host["overflow"])) * batch_size
            if dropped > 0:
                print(f"WARNING: rasterizer dropped ~{dropped:.0f} "
                      "Gaussian-tile instances this epoch (binning capacity "
                      "overflow) — raise tile_expand.")
        else:
            avg = [0.0 for _ in LOSS_NAMES]
        losses.append(avg)
        print(f"epoch {epoch}: " +
              " ".join(f"{k}={v:.5f}" for k, v in zip(LOSS_NAMES, avg)))

        if epoch % config.valid_every == 0:
            vlosses = []
            for b_num, batch in enumerate(valid_loader):
                loss, _ = eval_fn(batch)
                vlosses.append(loss)
                if max_batches and b_num + 1 >= max_batches:
                    break
            validation_losses.append(
                float(torch.stack(vlosses).mean()) if vlosses else 0.0)
            print(f"  validation: {validation_losses[-1]:.5f}")

        if epoch % config.save_every == 0:
            save_checkpoint(ckpt_fn, state, extra={
                "epoch": epoch,
                "losses": losses,
                "validation_losses": validation_losses,
                "loss_names": list(LOSS_NAMES),
            })

    return state, losses, validation_losses
