"""Gaussian rasterization: 3D perspective (:func:`rasterize`) and 2D image
space (:func:`rasterize_2d`); counterpart of
``pose_splatter_tpu/ops/rasterize.py``.

3D semantics (gsplat's): Gaussians are projected per camera and composited
in depth order, ``a = min(0.999, o · exp(−σ))`` of the conic quadratic form
σ, skipped where σ < 0 or a < 1/255, a contribution dropped once T·(1 − a)
would fall below 1e-4, pixel centres at +0.5.

2D semantics (the reference's 2D mode): Gaussians are composited in INPUT
order, ``a = o · exp(−(u²/(2sx²+1e-8) + v²/(2sy²+1e-8)))`` in the rotated
frame, no alpha clamp, skip or early stop, integer pixel coordinates.

Both composite the background by transmittance. Two modes:

- ``"global"``: every Gaussian on every pixel (the exact oracle, used by
  tests; :func:`composite_pixels`), differentiated by autograd through its
  cumprod scan;
- ``"kernel"``: the production path, the port's name for the JAX package's
  ``"pallas"`` mode. Gaussians are binned by their radius (3D: the
  projection's; 2D: the ``sigma_cutoff`` circle) into (8, 128) pixel tiles,
  all cameras folded into one tile axis, and composited by
  :func:`~pose_splatter_torch.ops.rasterize_kernels.composite_with_grad`
  (the CUDA kernels on the card, their plain versions on the CPU) in
  ``"conic"`` (3D) or ``"ellipse"`` (2D) mode. It is differentiable end to
  end: projection, depth permutation, pack, gather, composite, untile and
  background. The binning itself (tile spans from the centres and radii)
  is integer work and carries no gradient.

The tile shape is part of the result in ``"kernel"`` mode: an ellipse
instance is evaluated on every pixel of every tile its circle touches, with
no cutoff inside the tile, so pixels beyond 3σ get a contribution in some
tiles and none in others. The default stays the JAX package's (8, 128).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pose_splatter_torch.ops.projection import project_gaussians
from pose_splatter_torch.ops.rasterize_kernels import (
    ALPHA_CLAMP,
    ALPHA_SKIP,
    DEFAULT_EXPAND,
    F,
    STOP_T,
    _build_instances,
    composite_with_grad,
    gather_instances,
    instance_rows,
    pack_conic,
    pack_ellipse,
    permute_rows,
)
from pose_splatter_torch.utils import stages

DEFAULT_TILE = (8, 128)
DEFAULT_CHUNK_GLOBAL = 32
DEFAULT_CHUNK = 64  # G: instance rows per chunk (binning alignment)


def _alpha_conic(feats, xs, ys):
    """[chunk] Gaussians x [P] pixels → [chunk, P] alphas (3D mode: clamp
    at 0.999, skip below 1/255 or where σ < 0; ``rasterize.py:69-79``)."""
    mean2d, conic, opacity = feats
    dx = xs[None, :] - mean2d[:, 0:1]
    dy = ys[None, :] - mean2d[:, 1:2]
    sigma = (0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
             + conic[:, 1:2] * dx * dy)
    alpha = torch.clamp(opacity[:, None] * torch.exp(-sigma), max=ALPHA_CLAMP)
    return torch.where((sigma < 0) | (alpha < ALPHA_SKIP),
                       torch.zeros_like(alpha), alpha)


def _alpha_ellipse(feats, xs, ys):
    """[chunk] Gaussians x [P] pixels → [chunk, P] alphas."""
    mean2d, scales, theta, opacity = feats
    dx = xs[None, :] - mean2d[:, 0:1]
    dy = ys[None, :] - mean2d[:, 1:2]
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    dxr = c * dx + s * dy
    dyr = -s * dx + c * dy
    sx2 = 2.0 * scales[:, 0:1] ** 2 + 1e-8
    sy2 = 2.0 * scales[:, 1:2] ** 2 + 1e-8
    return opacity[:, None] * torch.exp(-(dxr * dxr / sx2 + dyr * dyr / sy2))


def composite_pixels(xs, ys, feats, colors, valid, chunk: int = 32,
                     alpha_fn=_alpha_ellipse, early_stop: bool = False):
    """Front-to-back composite N Gaussians over P pixels (forward of the
    JAX chunked scan): per chunk, T = T_in · exclusive cumprod(1 − a). With
    ``early_stop`` (3D mode) a contribution counts only where
    T·(1 − a) >= 1e-4, the per-pixel stop. Returns rgb [P, 3], alpha [P]."""
    N = colors.shape[0]
    P = xs.shape[0]
    msk = valid.to(colors.dtype)
    t_in = torch.ones((P,), dtype=colors.dtype, device=colors.device)
    rgb = torch.zeros((P, 3), dtype=colors.dtype, device=colors.device)
    alpha = torch.zeros((P,), dtype=colors.dtype, device=colors.device)
    for c0 in range(0, N, chunk):
        f = tuple(x[c0:c0 + chunk] for x in feats)
        a = alpha_fn(f, xs, ys) * msk[c0:c0 + chunk, None]
        cp = torch.cumprod(1.0 - a, dim=0)
        excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
        T = t_in[None, :] * excl
        contrib = a * T
        if early_stop:
            contrib = torch.where(T * (1.0 - a) >= STOP_T, contrib,
                                  torch.zeros_like(contrib))
        rgb = rgb + contrib.T @ colors[c0:c0 + chunk]
        alpha = alpha + contrib.sum(dim=0)
        t_in = t_in * cp[-1]
    return rgb, alpha


def _composite_global(feats, colors, valid, height, width, chunk,
                      alpha_fn=_alpha_ellipse, early_stop: bool = False,
                      pixel_offset: float = 0.0):
    dev = colors.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=colors.dtype, device=dev) + pixel_offset,
        torch.arange(width, dtype=colors.dtype, device=dev) + pixel_offset,
        indexing="ij")
    rgb, alpha = composite_pixels(xs.reshape(-1), ys.reshape(-1), feats,
                                  colors, valid, chunk, alpha_fn, early_stop)
    return rgb.reshape(height, width, 3), alpha.reshape(height, width)


def _tile_grid(height: int, width: int, tile_shape: Tuple[int, int],
               device=None):
    """Tile origins [T, 2] int32 (y0, x0) in row-major tile order."""
    th, tw = tile_shape
    n_ty = -(-height // th)
    n_tx = -(-width // tw)
    ys = torch.arange(n_ty, dtype=torch.int32, device=device) * th
    xs = torch.arange(n_tx, dtype=torch.int32, device=device) * tw
    origins = torch.stack(
        [ys.repeat_interleave(n_tx), xs.repeat(n_ty)], dim=-1)
    return origins, n_ty, n_tx


class Instances(NamedTuple):
    """Binned instance arrays of B cameras, folded into one tile axis."""
    inst: torch.Tensor      # [B*mcap, 16] float32
    astarts: torch.Tensor   # [B*T] int32 (camera b's rows start at b*mcap)
    counts: torch.Tensor    # [B*T] int32
    origins: torch.Tensor   # [B*T, 2] int32
    overflow: torch.Tensor  # [] int64: instances dropped by either cap
    n_ty: int
    n_tx: int


def bin_instances(packed, center, radius, valid, height: int, width: int,
                  tile_shape: Tuple[int, int], chunk: int,
                  expand: int) -> Instances:
    """Bin B cameras' Gaussians (packed [B,N,16], center [B,N,2], radius
    [B,N], valid [B,N]) into one instance array with cameras folded into
    the tile axis (``rasterize.py:402-462``). Each camera holds at most
    4·N + T·chunk instance rows, as in the JAX package; rows past that are
    dropped and counted."""
    origins, n_ty, n_tx = _tile_grid(height, width, tile_shape, packed.device)
    T = n_ty * n_tx
    B, N = packed.shape[:2]
    mcap = instance_rows(N, T, expand, chunk, cap=4 * N + T * chunk)
    # Zero-sanitize invalid rows: zero opacity keeps them inert.
    packed = torch.where(valid[..., None], packed, torch.zeros_like(packed))
    dest, src, astarts, counts, overflow = _build_instances(
        center.detach(), radius.detach(), valid, n_ty, n_tx, tile_shape,
        expand, chunk, mcap)
    inst = gather_instances(packed, dest, src, mcap)  # [B, mcap, 16]
    offs = (torch.arange(B, dtype=torch.int32, device=packed.device)
            * mcap)[:, None]
    return Instances(
        inst=inst.reshape(B * mcap, inst.shape[-1]),
        astarts=(astarts + offs).reshape(-1).contiguous(),
        counts=counts.reshape(-1).contiguous(),
        origins=origins.repeat(B, 1).contiguous(),
        overflow=overflow.sum(), n_ty=n_ty, n_tx=n_tx)


def untile(rgb_t, alpha_t, B: int, n_ty: int, n_tx: int,
           tile_shape: Tuple[int, int], height: int, width: int):
    """Per-tile rgb [B*T,3,P], alpha [B*T,P] → images [B,H,W,3], [B,H,W]."""
    th, tw = tile_shape
    rgb = (rgb_t.reshape(B, n_ty, n_tx, 3, th, tw)
           .permute(0, 1, 4, 2, 5, 3)
           .reshape(B, n_ty * th, n_tx * tw, 3)[:, :height, :width])
    alpha = (alpha_t.reshape(B, n_ty, n_tx, th, tw)
             .permute(0, 1, 3, 2, 4)
             .reshape(B, n_ty * th, n_tx * tw)[:, :height, :width])
    return rgb, alpha


def _composite_instances(packed, center, radius, valid, mode: str,
                         height: int, width: int, tile_shape, chunk: int,
                         expand: int):
    """Instance-binned compositing over a batch of cameras. Returns
    rgb [B,H,W,3], alpha [B,H,W] and the total overflow count."""
    b = bin_instances(packed, center, radius, valid, height, width,
                      tile_shape, chunk, expand)
    stages.mark("binning", b)
    rgb_t, alpha_t = composite_with_grad(
        b.inst, b.astarts, b.counts, b.origins, tile_shape, chunk, mode)
    stages.mark("kernel")
    rgb, alpha = untile(rgb_t, alpha_t, packed.shape[0], b.n_ty, b.n_tx,
                        tile_shape, height, width)
    stages.mark("untile")
    return rgb, alpha, b.overflow


def rasterize(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmats: torch.Tensor,
    Ks: torch.Tensor,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    backgrounds: Optional[torch.Tensor] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    tile_shape: Optional[Tuple[int, int]] = None,
    chunk: Optional[int] = None,
    tile_expand: Optional[int] = None,
    mode: str = "kernel",
    return_overflow: bool = False,
):
    """3D Gaussian splatting for a batch of cameras (``rasterize.py:531-695``).

    means/quats/scales/opacities/colors: [N,3],[N,4],[N,3],[N],[N,3]
    world-space Gaussians (scales linear, opacities in [0, 1]);
    viewmats [B,4,4], Ks [B,3,3]; valid: optional [N] bool; backgrounds:
    optional [3] or [B,3], composited by transmittance.

    ``"kernel"`` mode projects all B cameras, orders each camera's
    Gaussians by depth (invalid ones last, at +inf) with a stable sort as
    ``jnp.argsort`` does, packs them before the sort so the depth order is
    one row permutation of the flattened B·N rows (:func:`permute_rows`,
    whose backward is a gather), and composites every camera in one conic
    launch. ``"global"`` (the oracle) composites each camera's sorted
    Gaussians on every pixel.

    Returns rgb [B,H,W,3], alpha [B,H,W] (+ the overflow count [] if
    requested: instances dropped by the binning's capacity; 0 in
    ``"global"`` mode).
    """
    N = means.shape[0]
    dev = means.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    proj = project_gaussians(means, quats, scales, viewmats, Ks, width, height,
                             near_plane=near_plane, far_plane=far_plane,
                             radius_clip=radius_clip)  # [B, N, ...]
    ok = proj.valid & valid[None, :]
    keys = torch.where(ok, proj.depth, torch.full_like(proj.depth, math.inf))
    order = torch.sort(keys, dim=1, stable=True).indices  # depth order
    B = order.shape[0]
    ok_s = torch.gather(ok, 1, order)
    if mode == "kernel":
        packed = pack_conic(proj.mean2d, proj.conic,
                            opacities[None].expand(B, N),
                            colors[None].expand(B, N, 3), proj.radius)
        flat_order = (order + (torch.arange(B, device=dev) * N)[:, None]
                      ).reshape(-1)
        packed = permute_rows(packed.reshape(B * N, F),
                              flat_order).reshape(B, N, F)
        rgb, alpha, overflow = _composite_instances(
            packed, packed[..., 0:2], packed[..., 10], ok_s, "conic", height,
            width, tile_shape or DEFAULT_TILE, chunk or DEFAULT_CHUNK,
            tile_expand or DEFAULT_EXPAND)
    elif mode == "global":
        outs = []
        for b in range(B):
            o = order[b]
            feats = (proj.mean2d[b][o], proj.conic[b][o], opacities[o])
            outs.append(_composite_global(
                feats, colors[o], ok_s[b], height, width,
                chunk or DEFAULT_CHUNK_GLOBAL, _alpha_conic, True, 0.5))
        rgb = torch.stack([x[0] for x in outs])
        alpha = torch.stack([x[1] for x in outs])
        overflow = torch.zeros((), dtype=torch.long, device=dev)
    else:
        raise ValueError(f"unknown 3D render mode {mode!r} "
                         "(expected 'global' or 'kernel')")
    if backgrounds is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * backgrounds.reshape(-1, 1, 1, 3)
    if return_overflow:
        return rgb, alpha, overflow
    return rgb, alpha


def rasterize_2d(
    means2d: torch.Tensor,
    scales2d: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    sigma_cutoff: float = 3.0,
    tile_shape: Optional[Tuple[int, int]] = None,
    chunk: Optional[int] = None,
    tile_expand: Optional[int] = None,
    mode: str = "global",
    return_overflow: bool = False,
):
    """2D Gaussian splatting in pixel space.

    means2d [N,2] (u, v) pixels, or [B,N,2] for B views of the same
    Gaussians (the view-anchored model); scales2d [N,2] pixel sigmas
    (linear); rotations [N] radians; opacities [N]; colors [N,3].

    Returns rgb [H,W,3], alpha [H,W] (with a leading [B] for batched
    means), plus the overflow count if requested.
    """
    batched = means2d.dim() == 3
    if not batched:
        means2d = means2d[None]
    B, N = means2d.shape[:2]
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=means2d.device)
    if tile_expand is None:
        tile_expand = DEFAULT_EXPAND
    overflow = torch.zeros((), dtype=torch.long, device=means2d.device)
    if mode == "global":
        outs = [_composite_global(
            (means2d[b], scales2d, rotations, opacities), colors, valid,
            height, width, chunk or DEFAULT_CHUNK_GLOBAL) for b in range(B)]
        rgb = torch.stack([o[0] for o in outs])
        alpha = torch.stack([o[1] for o in outs])
    elif mode == "kernel":
        radius = sigma_cutoff * torch.maximum(scales2d[:, 0], scales2d[:, 1])
        packed = pack_ellipse(
            means2d, scales2d.expand(B, N, 2), rotations.expand(B, N),
            opacities.expand(B, N), colors.expand(B, N, 3),
            radius.expand(B, N))
        rgb, alpha, overflow = _composite_instances(
            packed, means2d, radius.expand(B, N), valid.expand(B, N),
            "ellipse", height, width, tile_shape or DEFAULT_TILE,
            chunk or DEFAULT_CHUNK, tile_expand)
    else:
        raise ValueError(f"unknown 2D render mode {mode!r} "
                         "(expected 'global' or 'kernel')")
    if background is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * background.reshape(1, 1, 1, 3)
    if not batched:
        rgb, alpha = rgb[0], alpha[0]
    if return_overflow:
        return rgb, alpha, overflow
    return rgb, alpha
