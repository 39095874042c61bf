"""Config-driven training (counterpart of
``pose_splatter_tpu/train/trainer.py``): ``build_model`` and
``train_from_config``, the reference's ``train_script.py`` loop over the
train step: per-epoch training over shuffled frames, validation every
``valid_every`` epochs, GT/prediction and loss-curve plots every
``plot_every`` (skipped where matplotlib is missing, as in the JAX
trainer), checkpoints every ``save_every``, ``load`` to resume.
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
    no fallback between the two). The JAX package's name ``"pallas"`` is
    taken as ``"kernel"``; ``"tiled"`` (the JAX package's default off the
    TPU) and ``"global"`` run in plain PyTorch. ``cameras`` = (intrinsics
    [C,3,3], extrinsics [C,4,4]) replaces loading ``config.camera_fn``.
    ``adaptive_camera``, ``carve_visibility_cap`` and ``remat_unets`` go to
    the model as the JAX trainer passes them (``trainer.py:38-75``).
    """
    if render_mode is None:
        render_mode = config.get("render_mode", "kernel")
    render_mode = {"pallas": "kernel"}.get(render_mode, render_mode)
    if render_mode not in ("kernel", "tiled", "global"):
        raise ValueError(f"unknown render_mode {render_mode!r}")
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
        adaptive_camera=config.adaptive_camera,
        gaussian_mode=config.gaussian_mode,
        gaussian_config=config.gaussian_config,
        render_mode=render_mode,
        min_n=config.get("min_n", 1024),
        max_n=config.get("max_n", 16000),
        num_unets=config.get("num_unets", 3),
        base_filters=config.get("base_filters", 8),
        carve_visibility_cap=config.get("carve_visibility_cap", None),
        remat_unets=config.get("remat_unets", False),
        device=device,
        seed=seed,
    )


def make_adaptive_fn(model: PoseSplatter):
    """Alias of :meth:`PoseSplatter.make_adaptive_fn` (``trainer.py:78-81``);
    it runs in the loader's threads, on the host."""
    return model.make_adaptive_fn()


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
    make_plots: bool = True,
    progress: bool = True,
):
    """Run training (``trainer.py:114-249``); returns (state, losses,
    validation_losses).

    ``make_plots`` writes ``reconstruction.pdf`` and ``loss.pdf`` (with an
    ``_ablation`` suffix when ablating) into the project directory every
    ``plot_every`` epochs, where matplotlib is installed; ``progress``
    prints each epoch's losses and the validation loss.

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
    model = build_model(config, ablation=ablation, device=device,
                        cameras=cameras, seed=seed)
    train_ds, valid_ds = datasets if datasets is not None else build_datasets(config)
    adaptive_fn = make_adaptive_fn(model) if config.adaptive_camera else None
    loader = FrameLoader(train_ds, batch_size=batch_size, shuffle=True,
                         seed=seed, adaptive_fn=adaptive_fn)
    valid_loader = FrameLoader(valid_ds, batch_size=batch_size, shuffle=False,
                               seed=seed, adaptive_fn=adaptive_fn)

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
        if progress:
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
            if progress:
                print(f"  validation: {validation_losses[-1]:.5f}")

        if make_plots and epoch % config.plot_every == 0:
            try:
                from pose_splatter_torch.viz.plots import (
                    plot_losses,
                    plot_predictions,
                )

                suffix = "_ablation" if ablation else ""
                os.makedirs(config.project_directory, exist_ok=True)
                plot_predictions(model, train_ds, save_path=os.path.join(
                    config.project_directory, f"reconstruction{suffix}.pdf"))
                plot_losses(losses, validation_losses, config.valid_every,
                            save_path=os.path.join(config.project_directory,
                                                   f"loss{suffix}.pdf"))
            except ImportError:
                pass

        if epoch % config.save_every == 0:
            save_checkpoint(ckpt_fn, state, extra={
                "epoch": epoch,
                "losses": losses,
                "validation_losses": validation_losses,
                "loss_names": list(LOSS_NAMES),
            })

    return state, losses, validation_losses
