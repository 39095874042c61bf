"""PoseSplatter: feed-forward Gaussian splatting from multi-view silhouettes.

Counterpart of ``pose_splatter_tpu/models/pose_splatter.py`` for the 2D
forward, in eval and train mode:

    carve → residual 3D U-Nets → Gaussian selection → per-voxel MLP head →
    (view-anchored) projection → 2D rasterization.

The 3D Gaussian mode comes in a later change.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pose_splatter_torch.models.unet3d import NewStats, Unet3D, flax_init_
from pose_splatter_torch.ops.carving import carve_volume
from pose_splatter_torch.ops.rasterize import rasterize_2d
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.device import resolve_device
from pose_splatter_torch.utils.geometry import (
    create_3d_grid,
    project_points,
    yaw_rotation,
)


class GaussianSelection(NamedTuple):
    indices: torch.Tensor  # [max_n] voxel indices (by descending occupancy)
    valid: torch.Tensor  # [max_n] bool
    probs: torch.Tensor  # [max_n] selection probabilities at the final mt
    mask_threshold: torch.Tensor  # [] final threshold


def select_gaussians(
    vol0: torch.Tensor,
    min_n: int,
    max_n: int,
    prob_threshold: float,
    mask_threshold: float,
    mask_threshold_delta: float,
) -> GaussianSelection:
    """Adaptive threshold + top-``max_n`` selection (``pose_splatter.py:56-81``).

    The threshold ``mt`` steps up by ``delta`` while more than ``max_n``
    voxels exceed ``mt + logit(pt)``, then down while fewer than ``min_n``
    do, in float32 as the JAX loops do. Both counts are read off the sorted
    values (count(t) > max_n iff the (max_n+1)-th largest value exceeds t),
    so the loops run on the host over two scalars.

    Ties: ``jax.lax.top_k`` puts the lower index first among equal values,
    and 2D compositing follows the selection order, so the order is taken
    from a stable descending sort (``torch.topk`` gives no tie order).
    """
    N = vol0.shape[0]
    if not 1 <= min_n <= max_n <= N:
        raise ValueError(f"need 1 <= min_n <= max_n <= N, got {min_n}, "
                         f"{max_n}, {N}")
    vals_sorted, order = torch.sort(vol0, descending=True, stable=True)
    f32 = np.float32
    lp = f32(math.log(prob_threshold / (1.0 - prob_threshold)))
    delta = f32(mask_threshold_delta)
    probe = [min_n - 1] + ([max_n] if max_n < N else [])
    host = vals_sorted[probe].detach().cpu().numpy()
    v_lo = host[0]
    if not np.isfinite(v_lo):
        raise ValueError("non-finite occupancy values in selection")
    mt = f32(mask_threshold)
    steps = 0
    if max_n < N:
        v_hi = host[1]
        while v_hi > f32(mt + lp):
            mt = f32(mt + delta)
            steps += 1
            if steps > 10_000_000:
                raise RuntimeError("mask threshold loop did not terminate")
    while not v_lo > f32(mt + lp):
        mt = f32(mt - delta)
        steps += 1
        if steps > 10_000_000:
            raise RuntimeError("mask threshold loop did not terminate")
    vals = vals_sorted[:max_n]
    mt_t = torch.tensor(mt, dtype=torch.float32, device=vol0.device)
    thr = torch.tensor(f32(mt + lp), dtype=torch.float32, device=vol0.device)
    return GaussianSelection(indices=order[:max_n], valid=vals > thr,
                             probs=torch.sigmoid(vals - mt_t),
                             mask_threshold=mt_t)


def take_rows_unique(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along rows, for UNIQUE indices (``pose_splatter.py:84-107``).

    The JAX function gives the gather a scatter-SET adjoint. Here the
    gather's own backward is a scatter-ADD (``index_add_``); with unique
    indices no two rows meet, so it computes the same gradient, and on the
    card no two atomics hit one address, so it is deterministic. Only top-k
    indices, unique by construction, may come here."""
    return x.index_select(0, idx)


class PoseSplatterNet(nn.Module):
    """Trainable parameters: U-Net stack, Gaussian MLP head, scale offset.
    Module names follow the Flax module so the weight bridge is a rename."""

    def __init__(self, in_channels: int = 4, out_channels: int = 8,
                 base_filters: int = 8, num_unets: int = 3,
                 input_size: Sequence[int] = (64, 64, 64),
                 num_gaussian_params: int = 14, ablation: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.ablation = ablation
        if not ablation:
            self.unets = nn.ModuleList([
                Unet3D(in_channels, in_channels, base_filters,
                       input_size=input_size)
                for _ in range(num_unets - 1)])
            self.final_unet = Unet3D(in_channels, out_channels, base_filters,
                                     input_size=input_size)
        self.head1 = nn.Linear(out_channels, 128)
        self.head2 = nn.Linear(128, num_gaussian_params)
        flax_init_(self.head1)
        flax_init_(self.head2)
        self.scale = nn.Parameter(torch.full((1,), -5.5))

    def process_volume(self, volume: torch.Tensor,
                       new_stats: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
        """volume [1, n1, n2, n3, in_ch] (NDHWC) → [out_ch, n1*n2*n3].

        Eval mode reads the running BN statistics. Given a ``new_stats``
        dict, it runs in train mode (batch statistics, Flax's
        ``mutable=["batch_stats"]``) and fills the dict with the updated
        running statistics under their buffer names; the buffers themselves
        are not written."""
        if self.ablation:
            v = volume[0]
            pad = torch.zeros(v.shape[:-1] + (self.out_channels - self.in_channels,),
                              dtype=v.dtype, device=v.device)
            return torch.cat([v, pad], -1).reshape(-1, self.out_channels).T
        collect: Optional[NewStats] = None if new_stats is None else {}
        v = volume.permute(0, 4, 1, 2, 3)  # NCDHW
        for unet in self.unets:
            v = v + unet(v, collect)
        v = self.final_unet(v, collect)
        if collect:
            for name, mod in self.named_modules():
                if mod in collect:
                    mean, var = collect[mod]
                    new_stats[f"{name}.running_mean"] = mean
                    new_stats[f"{name}.running_var"] = var
        return v[0].reshape(self.out_channels, -1)

    def gaussian_head(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [n, out_ch] → [n, P]."""
        return self.head2(F.relu(self.head1(feats)))


@torch.no_grad()
def init_means2d_center(net: PoseSplatterNet, W: int, H: int,
                        sigma_px: float = 2.0, anchored: bool = False) -> None:
    """2D-mode init aid, in place (``pose_splatter.py:180-203``): bias the
    head so means2d start at the image center (not in anchored mode, where
    means are deltas from the voxel projection) and set the shared
    log-scale to ``log(sigma_px)``."""
    if not anchored:
        net.head2.bias[0] = W / 2.0
        net.head2.bias[1] = H / 2.0
    net.scale.fill_(math.log(sigma_px))


class PoseSplatter(nn.Module):
    """Cameras, voxel grid and the net, with the 2D forward.

    Built in eval mode on ``device`` (default ``"cuda"``; raises without a
    CUDA device). Weights are initialized from ``seed`` without touching
    the global RNG; load trained or bridged weights into ``self.net``.
    """

    def __init__(
        self,
        intrinsics: np.ndarray,
        extrinsics: np.ndarray,
        W: int,
        H: int,
        in_channels: int = 4,
        out_channels: int = 8,
        base_filters: int = 8,
        ell: float = 0.18,
        grid_size: int = 64,
        min_n: int = 1024,
        max_n: int = 16000,
        num_unets: int = 3,
        color_clip: Tuple[float, float] = (0.0, 0.99),
        prob_threshold: float = 0.25,
        mask_threshold: float = 0.25,
        mask_threshold_delta: float = 0.05,
        volume_idx: Optional[Sequence[Sequence[int]]] = None,
        ablation: bool = False,
        volume_fill_color: float = 0.45,
        holdout_views: Sequence[int] = (),
        gaussian_mode: str = "2d",
        gaussian_config: Optional[Dict[str, Any]] = None,
        background_color: Sequence[float] = (1.0, 1.0, 1.0),
        render_mode: str = "kernel",
        tile_shape: Optional[Tuple[int, int]] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        if volume_idx is None:
            raise ValueError("volume_idx is required")
        if gaussian_mode == "3d":
            raise NotImplementedError("the 3D Gaussian mode is not ported yet")
        if gaussian_mode != "2d":
            raise ValueError(f"unknown gaussian_mode {gaussian_mode!r}")
        dev = resolve_device(device)
        self.W, self.H = W, H
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.min_n = min_n
        self.max_n = max_n
        self.color_clip = color_clip
        self.prob_threshold = prob_threshold
        self.mask_threshold = mask_threshold
        self.mask_threshold_delta = mask_threshold_delta
        self.volume_fill_color = float(volume_fill_color)
        self.holdout_views = list(holdout_views)
        self.gaussian_mode = gaussian_mode
        self.gaussian_config = dict(gaussian_config or {})
        self.render_mode = render_mode
        self.tile_shape = tile_shape

        C = len(intrinsics)
        self.num_cameras = C
        self.observed_views = [i for i in range(C) if i not in self.holdout_views]
        obs = np.asarray(self.observed_views)
        Ks = torch.as_tensor(np.asarray(intrinsics, np.float32))
        Es = torch.as_tensor(np.asarray(extrinsics, np.float32))
        self.register_buffer("Ks", Ks, persistent=False)
        self.register_buffer("viewmats", Es, persistent=False)
        self.register_buffer("Ks_obs", Ks[obs], persistent=False)
        self.register_buffer("viewmats_obs", Es[obs], persistent=False)
        self.register_buffer("background_color", torch.tensor(
            background_color, dtype=torch.float32), persistent=False)
        grid = torch.as_tensor(create_3d_grid(ell, grid_size, volume_idx=volume_idx))
        self.register_buffer("grid", grid, persistent=False)
        self.input_size = tuple(int(i2 - i1) for (i1, i2) in volume_idx)
        self.voxel_size = ell / grid_size
        self.num_gaussian_params = 9
        self.sigma_cutoff = float(self.gaussian_config.get("sigma_cutoff", 3.0))
        # Max tiles one Gaussian may span in the binning (overflow counted);
        # the model's default is 16 (pose_splatter.py:287-295).
        te = self.gaussian_config.get("tile_expand")
        self.tile_expand = int(te) if te is not None else 16
        # Anchor each 2D Gaussian at the projection of its pose-transformed
        # voxel center into the requested view; the MLP's means become a
        # pixel delta (a framework extension of the JAX package).
        self.view_anchored_2d = bool(self.gaussian_config.get("view_anchored", False))

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = PoseSplatterNet(
                in_channels=in_channels, out_channels=out_channels,
                base_filters=base_filters, num_unets=num_unets,
                input_size=self.input_size,
                num_gaussian_params=self.num_gaussian_params,
                ablation=ablation)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def carve(self, mask, img, p_3d, angle) -> torch.Tensor:
        """Shape-carve one frame. mask [C',H,W]; img [C',H,W,3] (observed
        views only) → volume [4, n1, n2, n3]."""
        return carve_volume(
            self._tensor(mask), self._tensor(img), self._tensor(p_3d),
            self._tensor(angle), self.grid, self.Ks_obs, self.viewmats_obs,
            volume_fill_color=self.volume_fill_color)

    # ------------------------------------------------------------------
    def gaussians_from_volume(self, vol_flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """vol_flat [out_ch, N] → dict of pixel-space Gaussian parameters."""
        sel = select_gaussians(
            vol_flat[0], self.min_n, self.max_n, self.prob_threshold,
            self.mask_threshold, self.mask_threshold_delta)
        feats = take_rows_unique(vol_flat.T, sel.indices)  # [max_n, out_ch]
        net_out = self.net.gaussian_head(feats)

        pt = self.prob_threshold
        logit_opac = torch.logit(torch.clamp(
            (1.0 / (1.0 - pt)) * (sel.probs - pt), 1e-6, 1.0 - 1e-6))
        scale_param = self.net.scale[0]
        means2d, scales2d, rotation, colors, _opac = torch.split(
            net_out, [2, 2, 1, 3, 1], dim=1)
        colors = torch.clamp(torch.sigmoid(colors), self.color_clip[0],
                             self.color_clip[1])
        out = dict(
            means2d=means2d,
            log_scales2d=scales2d + scale_param,
            rotation=rotation[:, 0],
            colors=colors,
            logit_opacities=logit_opac,
            valid=sel.valid,
        )
        if self.view_anchored_2d:
            out["anchor_means"] = self.grid.reshape(-1, 3)[sel.indices]
        return out

    # ------------------------------------------------------------------
    def render(self, g: Dict[str, torch.Tensor], view_idx):
        """Render to the cameras in ``view_idx`` (int or [B] ints).
        Returns rgb [B,H,W,3], alpha [B,H,W], overflow [] (instances
        dropped by finite binning capacity)."""
        view_idx = torch.as_tensor(view_idx, device=self.device).reshape(-1).long()
        B = view_idx.shape[0]
        if "anchor_means" in g:
            pix = project_points(g["anchor_means"], self.Ks[view_idx],
                                 self.viewmats[view_idx], clamp_z=True)
            means = pix + g["means2d"][None]  # [B,N,2]
        else:
            means = g["means2d"]
        rgb, alpha, overflow = rasterize_2d(
            means, torch.exp(g["log_scales2d"]), g["rotation"],
            torch.sigmoid(g["logit_opacities"]), g["colors"], self.W, self.H,
            valid=g["valid"], background=self.background_color,
            sigma_cutoff=self.sigma_cutoff, tile_shape=self.tile_shape,
            tile_expand=self.tile_expand, mode=self.render_mode,
            return_overflow=True)
        if "anchor_means" not in g:
            rgb = rgb[None].expand(B, *rgb.shape)
            alpha = alpha[None].expand(B, *alpha.shape)
        return rgb, alpha, overflow

    # ------------------------------------------------------------------
    def forward(self, mask, img, p_3d, angle, view_idx, train: bool = False,
                return_overflow: bool = False):
        """Forward for one frame (``pose_splatter.py:529-595``).

        mask [C',H,W]; img [C',H,W,3] (observed views, channel-last);
        p_3d [3]; angle scalar; view_idx int or [B] ints.

        Eval (the default): no graph, BN on the running statistics; returns
        rgb [B,H,W,3], alpha [B,H,W] (+ overflow [] if requested).

        ``train=True``: the graph for the backward, BN on batch statistics;
        returns rgb, alpha, the updated running statistics (a dict by
        buffer name; the buffers are not written) and the overflow, as the
        JAX forward with ``mutable=["batch_stats"]`` does.
        """
        if train:
            return self._forward(mask, img, p_3d, angle, view_idx, {})
        with torch.no_grad():
            rgb, alpha, _, overflow = self._forward(mask, img, p_3d, angle,
                                                    view_idx, None)
        if return_overflow:
            return rgb, alpha, overflow
        return rgb, alpha

    def _forward(self, mask, img, p_3d, angle, view_idx, new_stats):
        volume = self.carve(mask, img, p_3d, angle)  # [4,n1,n2,n3]
        stages.mark("carve")
        vol_flat = self.net.process_volume(volume.permute(1, 2, 3, 0)[None],
                                           new_stats)
        stages.mark("unets")
        g = self.gaussians_from_volume(vol_flat)
        if "anchor_means" in g:
            # Pose-transform the anchors only (deltas/scales stay as-is).
            rot = yaw_rotation(self._tensor(angle))
            g["anchor_means"] = g["anchor_means"] @ rot.T + self._tensor(p_3d)
        stages.mark("select_head", g)
        rgb, alpha, overflow = self.render(g, view_idx)
        return rgb, alpha, new_stats, overflow
