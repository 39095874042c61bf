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

Both composite the background by transmittance. Three modes:

- ``"global"``: every Gaussian on every pixel (the exact oracle, used by
  tests) through :func:`composite_pixels`, the chunk scan with the JAX
  package's O(P) backward (no [N, P] activation is stored);
- ``"tiled"``: the JAX package's XLA tiled compositor (its default off the
  TPU). Gaussians are binned into (64, 128) tiles by a circle/box test, each
  tile keeps its first ``tile_capacity`` in compositing order (the rest
  are counted in the overflow), and all tiles composite at once through
  :func:`composite_pixels`, in plain PyTorch on any device;
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
from torch.autograd.function import once_differentiable

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
DEFAULT_CHUNK = 64  # G: instance rows per chunk (binning alignment)
# "tiled" and "global" modes (``rasterize.py:59-62``): the XLA tile and the
# scan's chunk; a tile keeps min(N, TILE_CAPACITY) Gaussians.
DEFAULT_TILE_TILED = (64, 128)
DEFAULT_CHUNK_SCAN = 32
TILE_CAPACITY = 4096


def _alpha_conic(feats, xs, ys):
    """[..., chunk] Gaussians x [..., P] pixels → [..., chunk, P] alphas
    (3D mode: clamp at 0.999, skip below 1/255 or where σ < 0;
    ``rasterize.py:69-79``)."""
    mean2d, conic, opacity = feats
    dx = xs[..., None, :] - mean2d[..., 0:1]
    dy = ys[..., None, :] - mean2d[..., 1:2]
    sigma = (0.5 * (conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy * dy)
             + conic[..., 1:2] * dx * dy)
    alpha = torch.clamp(opacity[..., None] * torch.exp(-sigma),
                        max=ALPHA_CLAMP)
    return torch.where((sigma < 0) | (alpha < ALPHA_SKIP),
                       torch.zeros_like(alpha), alpha)


def _alpha_ellipse(feats, xs, ys):
    """[..., chunk] Gaussians x [..., P] pixels → [..., chunk, P] alphas
    (2D mode, ``rasterize.py:82-94``)."""
    mean2d, scales, theta, opacity = feats
    dx = xs[..., None, :] - mean2d[..., 0:1]
    dy = ys[..., None, :] - mean2d[..., 1:2]
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    dxr = c * dx + s * dy
    dyr = -s * dx + c * dy
    sx2 = 2.0 * scales[..., 0:1] ** 2 + 1e-8
    sy2 = 2.0 * scales[..., 1:2] ** 2 + 1e-8
    return opacity[..., None] * torch.exp(-(dxr * dxr / sx2 + dyr * dyr / sy2))


def _padded(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``axis`` up to ``n`` rows (the
    last chunk's zero-mask padding, ``_chunked``, ``rasterize.py:115-118``)."""
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _chunk_rows(n: int, chunk: int) -> int:
    """Rows of n Gaussians padded to whole chunks; at least one chunk, so
    that no Gaussians composite to nothing (T_bounds of ones)."""
    return max(-(-n // chunk), 1) * chunk


def _excl_cumprod(x: torch.Tensor):
    """Exclusive and inclusive cumulative products along the chunk axis."""
    cp = torch.cumprod(x, dim=-2)
    return torch.cat([torch.ones_like(cp[..., :1, :]), cp[..., :-1, :]],
                     dim=-2), cp


def _forward_scan(xs, ys, feats, colors, msk, alpha_fn, chunk: int,
                  early_stop: bool):
    """The chunk scan of ``_forward_scan`` (``rasterize.py:121-152``) over
    inputs padded to whole chunks along the Gaussian axis: per chunk,
    T = T_in · exclusive cumprod(1 − a); with ``early_stop`` a contribution
    counts only where T·(1 − a) >= 1e-4. Returns rgb [..., P, 3],
    alpha [..., P] and each chunk's entry T, T_bounds [..., n_chunks, P]."""
    ax = xs.dim() - 1
    t_in = torch.ones_like(xs, dtype=colors.dtype)
    rgb = torch.zeros(xs.shape + (3,), dtype=colors.dtype, device=xs.device)
    alpha = torch.zeros_like(t_in)
    bounds = []
    for c0 in range(0, colors.shape[ax], chunk):
        f = tuple(x.narrow(ax, c0, chunk) for x in feats)
        a = alpha_fn(f, xs, ys) * msk.narrow(ax, c0, chunk)[..., None]
        excl, incl = _excl_cumprod(1.0 - a)
        T = t_in[..., None, :] * excl
        contrib = a * T
        if early_stop:
            contrib = torch.where(T * (1.0 - a) >= STOP_T, contrib,
                                  torch.zeros_like(contrib))
        rgb = rgb + contrib.transpose(-2, -1) @ colors.narrow(ax, c0, chunk)
        alpha = alpha + contrib.sum(dim=-2)
        bounds.append(t_in)
        t_in = t_in * incl[..., -1, :]
    return rgb, alpha, torch.stack(bounds, dim=-2)


class _CompositePixels(torch.autograd.Function):
    """The chunk scan with the hand-derived O(P) backward of
    ``_make_compositor`` (``rasterize.py:155-244``). The forward keeps only
    its inputs and each chunk's entry transmittance; the backward walks the
    chunks in reverse, recomputes each chunk's alphas, carries the suffix
    sum s = Σ_{later} w·contrib with w = <g_rgb, colour> + g_alpha, forms
    dL/da = w·T·keep − s_i/(1 − a) and chains it through ``alpha_fn`` by
    ``torch.autograd.grad``, one chunk at a time. The positions get zero
    gradients, as the JAX VJP gives them."""

    @staticmethod
    def forward(ctx, alpha_fn, chunk, early_stop, xs, ys, colors, msk,
                *feats):
        ax = xs.dim() - 1
        rows = _chunk_rows(colors.shape[ax], chunk)
        rgb, alpha, t_bounds = _forward_scan(
            xs, ys, tuple(_padded(f, ax, rows) for f in feats),
            _padded(colors, ax, rows), _padded(msk, ax, rows), alpha_fn,
            chunk, early_stop)
        ctx.save_for_backward(xs, ys, colors, msk, t_bounds, *feats)
        ctx.cfg = (alpha_fn, chunk, early_stop)
        return rgb, alpha

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_alpha):
        xs, ys, colors, msk, t_bounds, *feats = ctx.saved_tensors
        alpha_fn, chunk, early_stop = ctx.cfg
        ax = xs.dim() - 1
        n = colors.shape[ax]
        n_chunks = t_bounds.shape[-2]
        rows = n_chunks * chunk
        feats_p = tuple(_padded(f, ax, rows) for f in feats)
        colors_p = _padded(colors, ax, rows)
        msk_p = _padded(msk, ax, rows)
        s = torch.zeros_like(t_bounds[..., 0, :])  # [..., P]
        dfeats, dcols, dmsks = [], [], []
        for j in reversed(range(n_chunks)):
            c0 = j * chunk
            f = tuple(x.narrow(ax, c0, chunk).detach().requires_grad_()
                      for x in feats_p)
            m = msk_p.narrow(ax, c0, chunk).detach().requires_grad_()
            with torch.enable_grad():
                a_g = alpha_fn(f, xs, ys) * m[..., None]
            a = a_g.detach()
            excl, _ = _excl_cumprod(1.0 - a)
            T = t_bounds[..., j, :][..., None, :] * excl  # the forward's T
            if early_stop:
                keep = (T * (1.0 - a) >= STOP_T).to(a.dtype)
            else:
                keep = torch.ones_like(a)
            contrib = a * T * keep
            col = colors_p.narrow(ax, c0, chunk)
            w = col @ g_rgb.transpose(-2, -1) + g_alpha[..., None, :]
            wc = w * contrib
            # Σ over the later rows of this chunk, then the later chunks.
            suffix = wc.flip(-2).cumsum(dim=-2).flip(-2) - wc
            da = w * T * keep - (s[..., None, :] + suffix) / (1.0 - a)
            grads = torch.autograd.grad(a_g, f + (m,), da, allow_unused=True)
            dfeats.append(tuple(torch.zeros_like(x) if g is None else g
                                for x, g in zip(f, grads[:-1])))
            dmsks.append(grads[-1])
            dcols.append(contrib @ g_rgb)
            s = s + wc.sum(dim=-2)

        def joined(parts):
            return torch.cat(parts[::-1], dim=ax).narrow(ax, 0, n)

        dfeats = [joined([d[i] for d in dfeats]) for i in range(len(feats))]
        return (None, None, None, torch.zeros_like(xs), torch.zeros_like(ys),
                joined(dcols), joined(dmsks), *dfeats)


def composite_pixels(xs, ys, feats, colors, valid, alpha_fn,
                     chunk: int = 32, early_stop: bool = True):
    """Front-to-back composite N Gaussians over P pixels
    (``rasterize.py:247-270``), with the O(P) backward of
    :class:`_CompositePixels`: no [N, P] activation is stored.

    xs, ys [..., P] pixel coordinates; feats a tuple of [..., N, ...]
    per-Gaussian screen features (in compositing order); colors [..., N, 3];
    valid [..., N], a mask (bool, or float to differentiate it); alpha_fn
    (chunk feats, xs, ys) → [..., chunk, P] alphas; ``early_stop`` the
    T < 1e-4 per-pixel stop (3D). Leading axes ``...`` batch independent
    composites (the tiles of :func:`_composite_tiled`, JAX's vmap).

    Returns rgb [..., P, 3], alpha [..., P].
    """
    return _CompositePixels.apply(alpha_fn, chunk, early_stop, xs, ys,
                                  colors, valid.to(colors.dtype),
                                  *tuple(feats))


def composite_pixels_ref(xs, ys, feats, colors, valid, alpha_fn,
                         chunk: int = 32, early_stop: bool = True):
    """Plain-autograd reference compositor (``rasterize.py:273-289``): the
    same scan, differentiated through its [chunk, P] activations. Tests
    hold :func:`composite_pixels` against it; memory-unbounded, it is on no
    path."""
    ax = xs.dim() - 1
    rows = _chunk_rows(colors.shape[ax], chunk)
    rgb, alpha, _ = _forward_scan(
        xs, ys, tuple(_padded(f, ax, rows) for f in feats),
        _padded(colors, ax, rows), _padded(valid.to(colors.dtype), ax, rows),
        alpha_fn, chunk, early_stop)
    return rgb, alpha


def _composite_global(feats, colors, valid, alpha_fn, height, width, chunk,
                      early_stop, pixel_offset):
    dev = colors.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=colors.dtype, device=dev) + pixel_offset,
        torch.arange(width, dtype=colors.dtype, device=dev) + pixel_offset,
        indexing="ij")
    rgb, alpha = composite_pixels(xs.reshape(-1), ys.reshape(-1), feats,
                                  colors, valid, alpha_fn, chunk, early_stop)
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


class TileBinning(NamedTuple):
    indices: torch.Tensor  # [T, K] Gaussian indices per tile (compositing order)
    valid: torch.Tensor  # [T, K] bool
    overflow: torch.Tensor  # [T] Gaussians dropped per tile


def bin_gaussians(center, radius, valid, tile_origins,
                  tile_shape: Tuple[int, int], capacity: int) -> TileBinning:
    """Assign Gaussians (in their compositing order) to pixel tiles
    (``rasterize.py:298-331``): center [N, 2] (x, y), radius [N], valid [N];
    tile_origins [T, 2] (y0, x0). A conservative circle/box overlap test;
    each tile keeps its first ``capacity`` intersecting Gaussians in their
    order (a stable sort of the integer key "not intersecting", as JAX's
    stable argsort of the bool) and counts the rest."""
    th, tw = tile_shape
    y0 = tile_origins[:, 0:1]
    x0 = tile_origins[:, 1:2]
    gx = center[None, :, 0]
    gy = center[None, :, 1]
    r = radius[None, :]
    intersects = (valid[None, :] & (gx + r >= x0) & (gx - r < x0 + tw)
                  & (gy + r >= y0) & (gy - r < y0 + th))  # [T, N]
    key = (~intersects).to(torch.uint8)
    order = torch.sort(key, dim=1, stable=True).indices[:, :capacity]
    count = intersects.sum(dim=1)
    return TileBinning(indices=order,
                       valid=torch.gather(intersects, 1, order),
                       overflow=torch.clamp(count - capacity, min=0))


def _composite_tiled(feats, colors, center, radius, valid, alpha_fn,
                     height: int, width: int, tile_shape: Tuple[int, int],
                     capacity: int, chunk: int, early_stop: bool,
                     pixel_offset: float):
    """Tiled compositing of one image (``rasterize.py:346-399``): every
    tile composites its binned Gaussians at once, the tiles a leading [T]
    axis of :func:`composite_pixels` (JAX's vmap). Returns rgb [H,W,3],
    alpha [H,W] and the overflow [T]."""
    th, tw = tile_shape
    origins, n_ty, n_tx = _tile_grid(height, width, tile_shape,
                                     colors.device)
    binning = bin_gaussians(center, radius, valid, origins, tile_shape,
                            capacity)
    feats_t = tuple(x[binning.indices] for x in feats)  # [T, K, ...]
    colors_t = colors[binning.indices]
    dy = torch.arange(th, dtype=colors.dtype, device=colors.device) + pixel_offset
    dx = torch.arange(tw, dtype=colors.dtype, device=colors.device) + pixel_offset
    yy, xx = torch.meshgrid(dy, dx, indexing="ij")
    tile_ys = origins[:, 0:1] + yy.reshape(1, -1)  # [T, th*tw]
    tile_xs = origins[:, 1:2] + xx.reshape(1, -1)
    rgb_t, alpha_t = composite_pixels(tile_xs, tile_ys, feats_t, colors_t,
                                      binning.valid, alpha_fn, chunk,
                                      early_stop)
    rgb = (rgb_t.reshape(n_ty, n_tx, th, tw, 3).permute(0, 2, 1, 3, 4)
           .reshape(n_ty * th, n_tx * tw, 3)[:height, :width])
    alpha = (alpha_t.reshape(n_ty, n_tx, th, tw).permute(0, 2, 1, 3)
             .reshape(n_ty * th, n_tx * tw)[:height, :width])
    return rgb, alpha, binning.overflow


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
                  tile_shape: Tuple[int, int], chunk: int, expand: int,
                  instance_cap: Optional[int] = None) -> Instances:
    """Bin B cameras' Gaussians (packed [B,N,16], center [B,N,2], radius
    [B,N], valid [B,N]) into one instance array with cameras folded into
    the tile axis (``rasterize.py:402-462``). Each camera holds at most
    ``instance_cap`` instance rows (default 4·N + T·chunk, as in the JAX
    package); rows past that are dropped and counted."""
    origins, n_ty, n_tx = _tile_grid(height, width, tile_shape, packed.device)
    T = n_ty * n_tx
    B, N = packed.shape[:2]
    if instance_cap is None:
        instance_cap = 4 * N + T * chunk
    mcap = instance_rows(N, T, expand, chunk, cap=instance_cap)
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
                         expand: int, instance_cap: Optional[int] = None):
    """Instance-binned compositing over a batch of cameras
    (``instance_cap`` as :func:`bin_instances`). Returns rgb [B,H,W,3],
    alpha [B,H,W] and the total overflow count."""
    b = bin_instances(packed, center, radius, valid, height, width,
                      tile_shape, chunk, expand, instance_cap)
    stages.binned(b.counts, b.overflow)
    stages.end("binning", b, then="kernel")
    rgb_t, alpha_t = composite_with_grad(
        b.inst, b.astarts, b.counts, b.origins, tile_shape, chunk, mode)
    stages.end("kernel", then="untile")
    rgb, alpha = untile(rgb_t, alpha_t, packed.shape[0], b.n_ty, b.n_tx,
                        tile_shape, height, width)
    stages.end("untile")
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
    tile_capacity: Optional[int] = None,
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
    launch. ``"tiled"`` bins each camera's sorted Gaussians by their
    projected radius into ``tile_shape`` tiles of at most
    ``tile_capacity`` (default min(N, 4096)) and composites them per
    camera; ``"global"`` (the oracle) composites them on every pixel.

    Returns rgb [B,H,W,3], alpha [B,H,W] (+ the overflow count [] if
    requested: instances, or in ``"tiled"`` mode Gaussians, dropped by the
    binning's capacity, summed over tiles and cameras; 0 in ``"global"``
    mode).
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
    elif mode in ("global", "tiled"):
        outs = []
        for b in range(B):
            o = order[b]
            feats = (proj.mean2d[b][o], proj.conic[b][o], opacities[o])
            if mode == "global":
                outs.append(_composite_global(
                    feats, colors[o], ok_s[b], _alpha_conic, height, width,
                    chunk or DEFAULT_CHUNK_SCAN, True, 0.5) + (None,))
            else:
                outs.append(_composite_tiled(
                    feats, colors[o], feats[0], proj.radius[b][o], ok_s[b],
                    _alpha_conic, height, width,
                    tile_shape or DEFAULT_TILE_TILED,
                    tile_capacity or min(N, TILE_CAPACITY),
                    chunk or DEFAULT_CHUNK_SCAN, True, 0.5))
        rgb = torch.stack([x[0] for x in outs])
        alpha = torch.stack([x[1] for x in outs])
        overflow = (torch.zeros((), dtype=torch.long, device=dev)
                    if mode == "global" else
                    torch.stack([x[2].sum() for x in outs]).sum())
    else:
        raise ValueError(f"unknown 3D render mode {mode!r} "
                         "(expected 'kernel', 'tiled' or 'global')")
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
    tile_capacity: Optional[int] = None,
    chunk: Optional[int] = None,
    tile_expand: Optional[int] = None,
    mode: str = "global",
    return_overflow: bool = False,
):
    """2D Gaussian splatting in pixel space.

    means2d [N,2] (u, v) pixels, or [B,N,2] for B views of the same
    Gaussians (the view-anchored model); scales2d [N,2] pixel sigmas
    (linear); rotations [N] radians; opacities [N]; colors [N,3].
    ``"tiled"`` and ``"kernel"`` bin by the ``sigma_cutoff`` circle,
    radius ``sigma_cutoff · max(sx, sy)``.

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
    radius = sigma_cutoff * torch.maximum(scales2d[:, 0], scales2d[:, 1])
    if mode == "global":
        outs = [_composite_global(
            (means2d[b], scales2d, rotations, opacities), colors, valid,
            _alpha_ellipse, height, width, chunk or DEFAULT_CHUNK_SCAN, False,
            0.0) for b in range(B)]
        rgb = torch.stack([o[0] for o in outs])
        alpha = torch.stack([o[1] for o in outs])
    elif mode == "tiled":
        outs = [_composite_tiled(
            (means2d[b], scales2d, rotations, opacities), colors, means2d[b],
            radius, valid, _alpha_ellipse, height, width,
            tile_shape or DEFAULT_TILE_TILED,
            tile_capacity or min(N, TILE_CAPACITY),
            chunk or DEFAULT_CHUNK_SCAN, False, 0.0) for b in range(B)]
        rgb = torch.stack([o[0] for o in outs])
        alpha = torch.stack([o[1] for o in outs])
        overflow = torch.stack([o[2].sum() for o in outs]).sum()
    elif mode == "kernel":
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
                         "(expected 'kernel', 'tiled' or 'global')")
    if background is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * background.reshape(1, 1, 1, 3)
    if not batched:
        rgb, alpha = rgb[0], alpha[0]
    if return_overflow:
        return rgb, alpha, overflow
    return rgb, alpha
