"""Training and diagnostic plots with matplotlib, host-side and optional
(counterpart of ``pose_splatter_tpu/viz/plots.py``).

- ``plot_predictions``: ground truth beside prediction for a few frames,
  saved every ``plot_every`` epochs by the trainer.
- ``plot_losses``: semilogy loss curves and the validation points.
- ``plot_voxels``: a carved occupancy volume from three angles.
- ``splat_volume_preview``: a carved volume's occupied voxels splatted as
  small fixed Gaussians through a real camera (``"tiled"`` mode).
- ``plot_gaussian_scatter``, ``plot_ellipses``: exported Gaussians, and
  the body Gaussian's per-frame ellipses with their tracked axes.

Each function imports matplotlib first, so without it nothing else runs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from pose_splatter_torch.ops.rasterize import rasterize
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.device import resolve_device

LOSS_NAMES = ("iou", "ssim", "img")
# The adaptive camera's host hook, a unit of its own while tracing.
_ADAPTIVE = stages.Scope("adaptive")
LOSS_COLORS = ["goldenrod", "deepskyblue", "lightcoral", "darkorchid",
               "mediumseagreen"]


def _plt():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return plt


def plot_predictions(model, dataset, save_path: str = "temp.pdf",
                     num_examples: int = 5, seed: int = 0) -> str:
    """GT | prediction column pairs for ``num_examples`` frames drawn from
    ``seed``, each rendered to the dataset's first observed view (an
    adaptive model with its frame's ``temp_K`` and seed)."""
    plt = _plt()
    rng = np.random.default_rng(seed)
    adaptive_fn = (model.make_adaptive_fn()
                   if getattr(model, "adaptive_camera", False) else None)
    _, axarr = plt.subplots(ncols=2, nrows=num_examples,
                            figsize=(4, 2 * num_examples))
    for j in range(num_examples):
        idx = int(rng.integers(len(dataset)))
        view = int(dataset.observed_views[0])
        mask, img, p_3d, angle, _ = dataset.get(idx, view_idx=view)
        obs_pos = list(dataset.observed_views).index(view)
        kw = {}
        if adaptive_fn is not None:
            with _ADAPTIVE:
                temp_K, seed_3d = adaptive_fn(mask)
            kw = dict(K_mask=np.asarray(temp_K, np.float32),
                      carve_center=np.asarray(seed_3d, np.float32))
        rgb, _ = model(mask, img, p_3d, angle, view, **kw)
        axarr[j, 0].imshow(img[obs_pos])
        axarr[j, 0].axis("off")
        axarr[j, 1].imshow(rgb[0].cpu().numpy().clip(0, 1))
        axarr[j, 1].axis("off")
    axarr[0, 0].set_title("Ground Truth")
    axarr[0, 1].set_title("Prediction")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close("all")
    return save_path


def plot_losses(losses: Sequence[Sequence[float]],
                validation_losses: Optional[Sequence[float]] = None,
                valid_every: Optional[int] = None,
                save_path: str = "loss.pdf") -> str:
    """Semilogy per-component training curves + validation points."""
    plt = _plt()
    num_epochs = len(losses)
    epochs = range(1, num_epochs + 1)
    for i, name in enumerate(LOSS_NAMES):
        plt.semilogy(epochs, [l[i] for l in losses], c=LOSS_COLORS[i],
                     label=name)
    plt.semilogy(epochs, [sum(l) for l in losses], c=LOSS_COLORS[-2],
                 label="all")
    if validation_losses and valid_every:
        val_epochs = range(valid_every, num_epochs + 1, valid_every)
        plt.plot(list(val_epochs)[: len(validation_losses)],
                 validation_losses, marker="o", color=LOSS_COLORS[-1],
                 label="val")
    ax = plt.gca()
    ax.minorticks_on()
    ax.grid(which="both")
    plt.legend(loc="best")
    plt.ylabel("Loss")
    plt.xlabel("Epoch")
    plt.title("Training and Validation Losses")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close("all")
    return save_path


def plot_voxels(volume: np.ndarray, save_path: str = "voxels.pdf",
                threshold: float = 0.5) -> str:
    """3-view matplotlib voxel plot of an occupancy volume [n1,n2,n3]."""
    plt = _plt()
    occ = volume > threshold
    fig = plt.figure(figsize=(12, 4))
    for i, (elev, azim) in enumerate([(20, 30), (20, 120), (80, 30)]):
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        ax.voxels(occ, edgecolor=None)
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close("all")
    return save_path


def volume_preview_image(volume: np.ndarray, grid: np.ndarray,
                         K: np.ndarray, E: np.ndarray, width: int,
                         height: int, threshold: float = 0.5,
                         log_scale: float = -7.0,
                         device: Union[str, torch.device] = "cuda"
                         ) -> np.ndarray:
    """The image :func:`splat_volume_preview` saves, rgb [height, width, 3]
    in [0, 1]: every voxel a Gaussian of scale exp(``log_scale``),
    identity quaternion, opacity 0.95 and the carve's colour, valid where
    the occupancy exceeds ``threshold``; ``"tiled"`` mode on a white
    background (``plots.py:140-173``)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    occ = torch.as_tensor(volume[0].reshape(-1) > threshold, device=dev)
    means = t(grid.reshape(-1, 3))
    colors = t(volume[1:4].reshape(3, -1).T)
    n = means.shape[0]
    quats = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1)
    scales = torch.full((n, 3), float(np.exp(log_scale)), device=dev)
    opac = torch.full((n,), 0.95, device=dev)
    with torch.no_grad():
        rgb, _ = rasterize(means, quats, scales, opac, colors, t(E)[None],
                           t(K)[None], width, height, valid=occ,
                           backgrounds=torch.ones(3, device=dev), mode="tiled")
    return np.clip(rgb[0].cpu().numpy(), 0, 1)


def splat_volume_preview(volume: np.ndarray, grid: np.ndarray,
                         K: np.ndarray, E: np.ndarray,
                         width: int, height: int,
                         threshold: float = 0.5,
                         log_scale: float = -7.0,
                         save_path: str = "volume_preview.png",
                         device: Union[str, torch.device] = "cuda") -> str:
    """Render a carved volume's occupied voxels as fixed-scale Gaussians
    through a real camera, the reference's carve-debug preview
    (:func:`volume_preview_image`), and save it as an image.

    volume [4, n1, n2, n3]; grid [n1, n2, n3, 3]; K [3,3]; E [4,4].
    """
    plt = _plt()
    plt.imsave(save_path, volume_preview_image(
        volume, grid, K, E, width, height, threshold, log_scale, device))
    return save_path


def plot_gaussian_scatter(g: dict, save_path: str = "gaussians.pdf") -> str:
    """3D scatter of exported Gaussians colored by their RGB
    (visualize_gaussian.py contract)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    m = g["means"]
    ax.scatter(m[:, 0], m[:, 1], m[:, 2], c=np.clip(g["colors"], 0, 1),
               s=2.0, alpha=0.5)
    ax.set_box_aspect([1, 1, 1])
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close("all")
    return save_path


def plot_ellipses(means: np.ndarray, covariances: np.ndarray,
                  save_path: str = "ellipses.pdf") -> str:
    """Per-frame body-Gaussian trajectory diagnostic: the xy projection of
    each frame's (mean, covariance) drawn as a 1-sigma ellipse with its
    tracked principal axis as an arrow, colored by frame index (one batched
    ``eigh`` over all frames).

    means [T, 3]; covariances [T, 3, 3].
    """
    plt = _plt()
    from matplotlib.colors import Normalize
    from matplotlib.patches import Ellipse

    from pose_splatter_torch.tracking import track_principal_axes

    means = np.asarray(means)
    covariances = np.asarray(covariances)
    T = len(means)
    axes2d = track_principal_axes(means, covariances)[:, :2]
    xy = means[:, :2]
    cov2d = covariances[:, :2, :2]

    evals, evecs = np.linalg.eigh(cov2d)  # [T, 2] asc, [T, 2, 2]
    # Ellipse orientation from the major (last) eigenvector; width/height
    # are the 1-sigma diameters along minor/major.
    major = evecs[:, :, -1]
    angles_deg = np.degrees(np.arctan2(major[:, 1], major[:, 0]))
    diam = 2.0 * np.sqrt(np.maximum(evals, 0.0))  # [T, 2] (minor, major)
    arrow = axes2d * (0.8 * np.sqrt(evals[:, -1:]))

    cmap = plt.get_cmap("viridis")
    norm = Normalize(vmin=0, vmax=T)
    _, ax = plt.subplots(figsize=(8, 6))
    for i in range(T):
        ax.add_patch(Ellipse(
            xy=xy[i], width=diam[i, 1], height=diam[i, 0],
            angle=float(angles_deg[i]), edgecolor="black",
            facecolor=cmap(norm(i)), alpha=0.7))
        ax.arrow(xy[i, 0], xy[i, 1], arrow[i, 0], arrow[i, 1], color="k")
    ax.set_xlabel("X-axis")
    ax.set_ylabel("Y-axis")
    ax.set_aspect("equal")

    stds = np.sqrt(np.maximum(cov2d[:, [0, 1], [0, 1]], 0.0))  # [T, 2]
    lo = (xy - 2 * stds).min(axis=0)
    hi = (xy + 2 * stds).max(axis=0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    plt.colorbar(sm, ax=ax, label="Gaussian Index")
    plt.savefig(save_path)
    plt.close("all")
    return save_path
