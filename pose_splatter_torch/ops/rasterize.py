"""2D image-space Gaussian rasterization (counterpart of the 2D half of
``pose_splatter_tpu/ops/rasterize.py``).

Semantics (the reference's 2D mode): Gaussians are composited in INPUT
order, ``a = o · exp(−(u²/(2sx²+1e-8) + v²/(2sy²+1e-8)))`` in the rotated
frame, no alpha clamp, skip or early stop, integer pixel coordinates, and
the background composited by transmittance.

Two modes:

- ``"global"``: every Gaussian on every pixel (the exact oracle, used by
  tests; ``composite_pixels`` forward);
- ``"kernel"``: the production path, the port's name for the JAX package's
  ``"pallas"`` mode. Gaussians are binned by their ``sigma_cutoff`` circle
  into (8, 128) pixel tiles, all cameras folded into one tile axis, and
  composited by :func:`~pose_splatter_torch.ops.rasterize_kernels.
  composite_with_grad` (the CUDA kernels on the card, their plain versions
  on the CPU). It is differentiable end to end: pack, gather, composite,
  untile and background. The binning itself (tile spans from the centres
  and radii) is integer work and carries no gradient.

``"global"`` is differentiated by autograd through its cumprod scan; it is
a test oracle.

The tile shape is part of the result in ``"kernel"`` mode: an instance is
evaluated on every pixel of every tile its circle touches, with no cutoff
inside the tile, so pixels beyond 3σ get a contribution in some tiles and
none in others. The default stays the JAX package's (8, 128).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pose_splatter_torch.ops.rasterize_kernels import (
    DEFAULT_EXPAND,
    _build_instances,
    composite_with_grad,
    gather_instances,
    instance_rows,
    pack_ellipse,
)
from pose_splatter_torch.utils import stages

DEFAULT_TILE = (8, 128)
DEFAULT_CHUNK_GLOBAL = 32
DEFAULT_CHUNK = 64  # G: instance rows per chunk (binning alignment)


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


def composite_pixels(xs, ys, feats, colors, valid, chunk: int = 32):
    """Front-to-back composite N ellipse Gaussians over P pixels (forward
    of the JAX chunked scan, 2D mode: no gate, no stop): per chunk,
    T = T_in · exclusive cumprod(1 − a). Returns rgb [P, 3], alpha [P]."""
    N = colors.shape[0]
    P = xs.shape[0]
    msk = valid.to(colors.dtype)
    t_in = torch.ones((P,), dtype=colors.dtype, device=colors.device)
    rgb = torch.zeros((P, 3), dtype=colors.dtype, device=colors.device)
    alpha = torch.zeros((P,), dtype=colors.dtype, device=colors.device)
    for c0 in range(0, N, chunk):
        f = tuple(x[c0:c0 + chunk] for x in feats)
        a = _alpha_ellipse(f, xs, ys) * msk[c0:c0 + chunk, None]
        cp = torch.cumprod(1.0 - a, dim=0)
        excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
        contrib = a * (t_in[None, :] * excl)
        rgb = rgb + contrib.T @ colors[c0:c0 + chunk]
        alpha = alpha + contrib.sum(dim=0)
        t_in = t_in * cp[-1]
    return rgb, alpha


def _composite_global(feats, colors, valid, height, width, chunk):
    dev = colors.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=colors.dtype, device=dev),
        torch.arange(width, dtype=colors.dtype, device=dev), indexing="ij")
    rgb, alpha = composite_pixels(xs.reshape(-1), ys.reshape(-1), feats,
                                  colors, valid, chunk)
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
