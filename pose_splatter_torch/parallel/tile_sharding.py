"""Tile-sharded rendering and the (data, tile) train step (counterpart of
``pose_splatter_tpu/parallel/tile_sharding.py``).

Gaussians are small (at most 16k rows of a few floats: every rank of the
``tile`` axis holds them all), pixels are many: each rank bins and
composites its own share of the pixel tiles (a contiguous block of the
tile list, padded with off-screen tiles to a multiple of the axis size),
and the strips are gathered after (:func:`rasterize_tile_sharded`).

:func:`make_tile_sharded_train_step` runs carve → U-Nets → Gaussians →
render → loss → gradient with the frame batch split over ``data`` and
each frame's pixel tiles over ``tile``: IoU and masked L1 from per-strip
partial sums and one ``psum`` over ``tile``, SSIM from each rank's image
band with the halo rows of the next ranks (:func:`_ssim_band_partial`),
the gradients averaged over ``data`` and then over ``tile``. The carve,
U-Nets and head run on every tile rank alike, in train-mode BN whose new
statistics are dropped, as in the JAX step.

Compositor names: the port's ``"tiled"`` is the JAX package's ``"xla"``
(``composite_pixels`` over each tile's binned Gaussians) and ``"kernel"``
its ``"pallas"`` (each rank's tiles as instance segments for the
hand-written compositors, ``ops/rasterize_kernels.py``). The kernels hold
at most 1024 pixels a tile, so ``"kernel"`` takes tiles such as (8, 128)
and raises on the JAX default (32, 128).

The JAX module's ``gather_strips`` (defined in its train step and never
called) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pose_splatter_torch.ops.projection import project_gaussians
from pose_splatter_torch.ops.rasterize import (
    _alpha_conic,
    _alpha_ellipse,
    _tile_grid,
    bin_gaussians,
    composite_pixels,
)
from pose_splatter_torch.ops.rasterize_kernels import (
    PIXEL_OFFSET,
    composite_with_grad,
    pack_conic,
    pack_ellipse,
)
from pose_splatter_torch.ops.ssim import _filter2d, _gaussian_kernel
from pose_splatter_torch.parallel.comm import (
    gather_strips,
    mean_over,
    pmean,
    ppermute,
    psum,
    replicated,
)
from pose_splatter_torch.parallel.mesh import Mesh
from pose_splatter_torch.utils.geometry import project_points, yaw_rotation


def _padded_origins(height, width, tile_shape, n_dev, row_aligned=False,
                    device=None):
    """Tile origins padded with off-screen tiles to a multiple of n_dev.

    ``row_aligned`` pads whole TILE ROWS instead (tile-row count to a
    multiple of n_dev), so each rank's shard is a contiguous horizontal
    image band, which the strip-halo SSIM needs. Returns (origins [T', 2]
    int32, n_ty, n_tx, pad).
    """
    origins, n_ty, n_tx = _tile_grid(height, width, tile_shape, device)
    n_tiles = origins.shape[0]
    if row_aligned:
        n_ty_pad = -(-n_ty // n_dev) * n_dev
        pad = n_ty_pad * n_tx - n_tiles
    else:
        pad = (-n_tiles) % n_dev
    if pad:
        # Off-screen origins: no Gaussian's bbox reaches them, so they
        # composite pure background and are sliced off after reassembly.
        off = torch.full((pad, 2), max(height, width) + 10 * max(tile_shape),
                         dtype=origins.dtype, device=origins.device)
        origins = torch.cat([origins, off], dim=0)
    return origins, n_ty, n_tx, pad


def _local(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis."""
    n = mesh.shape[axis]
    b = x.shape[0] // n
    return x[mesh.index(axis) * b:(mesh.index(axis) + 1) * b]


class _TakeRows(torch.autograd.Function):
    """``x[idx]`` for rows x [N, D] and indices idx [T, K]; the backward
    adds each row's gradients from its slots in a fixed order (a gather
    and a sum), not by a scatter-add whose order on the card changes."""

    @staticmethod
    def forward(ctx, x, idx, slots):
        ctx.save_for_backward(slots)
        ctx.shape = idx.shape
        return x.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        flat = g.reshape(-1, *g.shape[len(ctx.shape):])
        flat = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        return flat[slots].sum(1), None, None


def row_slots(idx: torch.Tensor, live: torch.Tensor, n: int) -> torch.Tensor:
    """slots [n, M]: for each row of the source, the flat positions (in
    order) of the ``live`` entries of idx [T, K] that read it, padded with
    T·K (a zero row); M is the largest count (one read of the device).
    The gather-reduce of ``gather_instances``: a stable sort of the
    positions by row gives each its rank, one scatter of unique indices
    fills the table."""
    flat = torch.where(live.reshape(-1), idx.reshape(-1),
                       torch.full_like(idx.reshape(-1), n))
    counts = torch.zeros(n + 1, dtype=torch.long, device=idx.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    m = max(int(counts[:n].max()) if n else 0, 1)
    sorted_rows, perm = torch.sort(flat, stable=True)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat.numel(), device=idx.device) - start[sorted_rows]
    slots = torch.full((n + 1, m), flat.numel(), dtype=torch.long,
                       device=idx.device)
    keep = sorted_rows < n
    slots[sorted_rows[keep], rank[keep]] = perm[keep]
    return slots[:n]


def _composite_local(origins_l, feats, cols, ok, center, radius, alpha_fn,
                     tile_shape, tile_capacity, chunk, early_stop,
                     pixel_offset, compositor, overflow=None):
    """Composite one camera's Gaussians onto this rank's tiles origins_l
    [T_l, 2]. Returns rgb [T_l, th·tw, 3], alpha [T_l, th·tw]; the count
    of Gaussians the tiles' capacity dropped is appended to the list
    ``overflow`` if one is given. ``compositor``: ``"tiled"`` (the JAX
    ``"xla"``) or ``"kernel"`` (the JAX ``"pallas"``).

    The rows of a tile that composite are the binning's live entries (the
    Gaussians it intersects, first in compositing order); their gradient
    reaches the Gaussians through :class:`_TakeRows` (the other entries
    carry none). ``"kernel"`` lays them out as the JAX ``"pallas"`` branch
    does: each tile's K rows padded to a multiple of the chunk,
    ``astarts = arange(T_l)·Kpad``, ``counts`` the live rows. The kernels
    tie the pixel offset and the early stop to the mode (conic: 0.5 and
    the stop; ellipse: 0.0 and none), so any other pair raises.
    """
    th, tw = tile_shape
    binning = bin_gaussians(center, radius, ok, origins_l, tile_shape,
                            tile_capacity)
    if overflow is not None:
        overflow.append(binning.overflow.sum())
    slots = row_slots(binning.indices, binning.valid, cols.shape[0])

    def take(x):
        return _TakeRows.apply(x, binning.indices, slots)

    if compositor == "kernel":
        mode = "conic" if alpha_fn is _alpha_conic else "ellipse"
        if (early_stop, pixel_offset) != (mode == "conic", PIXEL_OFFSET[mode]):
            raise ValueError(
                f"the {mode} kernel composites with early_stop "
                f"{mode == 'conic'} at pixel offset {PIXEL_OFFSET[mode]}, "
                f"not {early_stop} at {pixel_offset}")
        if mode == "conic":
            mean2d, conic, opac = feats
            packed = pack_conic(mean2d, conic, opac, cols, radius)
        else:
            mean2d, scales2d, theta, opac = feats
            packed = pack_ellipse(mean2d, scales2d, theta, opac, cols, radius)
        packed = torch.where(ok[:, None], packed, torch.zeros_like(packed))
        inst = take(packed) * binning.valid[..., None]  # [T_l, K, 16]
        T_l, K = binning.indices.shape
        Kpad = -(-K // chunk) * chunk
        inst = torch.nn.functional.pad(inst, (0, 0, 0, Kpad - K))
        counts = binning.valid.sum(dim=1).to(torch.int32)
        astarts = (torch.arange(T_l, dtype=torch.int32, device=inst.device)
                   * Kpad)
        rgb_t, alpha_t = composite_with_grad(
            inst.reshape(T_l * Kpad, inst.shape[-1]).contiguous(), astarts,
            counts, origins_l.to(torch.int32).contiguous(), tile_shape,
            chunk, mode)
        return rgb_t.transpose(1, 2), alpha_t
    if compositor != "tiled":
        raise ValueError(f"unknown compositor {compositor!r} "
                         "(expected 'tiled' or 'kernel')")
    dt = cols.dtype
    dy = torch.arange(th, dtype=dt, device=cols.device) + pixel_offset
    dx = torch.arange(tw, dtype=dt, device=cols.device) + pixel_offset
    yy, xx = torch.meshgrid(dy, dx, indexing="ij")
    tys = origins_l[:, 0:1].to(dt) + yy.reshape(1, -1)
    txs = origins_l[:, 1:2].to(dt) + xx.reshape(1, -1)
    feats_t = tuple(take(x) for x in feats)
    return composite_pixels(txs, tys, feats_t, take(cols), binning.valid,
                            alpha_fn, chunk=chunk, early_stop=early_stop)


def rasterize_tile_sharded(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmats: torch.Tensor,  # [B,4,4] camera batch (or [4,4])
    Ks: torch.Tensor,  # [B,3,3] (or [3,3])
    width: int,
    height: int,
    mesh: Mesh,
    axis: str = "tile",
    valid: Optional[torch.Tensor] = None,
    backgrounds: Optional[torch.Tensor] = None,
    tile_shape: Tuple[int, int] = (32, 128),
    tile_capacity: int = 1024,
    chunk: int = 32,
    compositor: str = "tiled",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rasterization with the pixel tiles split over ``mesh[axis]``.

    Each rank projects every camera's Gaussians, orders them by depth
    (invalid last; a stable sort, as ``jnp.argsort``), composites its own
    tiles of every camera and gathers the strips of the others; the tile
    count is padded to the axis size. Returns rgb [B,H,W,3], alpha [B,H,W]
    on every rank (the leading axis squeezed for an unbatched camera),
    differentiable: the gradient of a loss that every rank computes on the
    whole image is the whole gradient on every rank.
    """
    squeeze = viewmats.dim() == 2
    if squeeze:
        viewmats, Ks = viewmats[None], Ks[None]
    N = means.shape[0]
    B = viewmats.shape[0]
    dev = means.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    means, quats, scales, opacities, colors = (
        replicated(x, mesh, axis)
        for x in (means, quats, scales, opacities, colors))

    proj = project_gaussians(means, quats, scales, viewmats, Ks, width, height)
    ok = proj.valid & valid[None]
    keys = torch.where(ok, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.sort(keys, dim=1, stable=True).indices  # [B, N]

    th, tw = tile_shape
    origins, n_ty, n_tx, pad = _padded_origins(
        height, width, tile_shape, mesh.shape[axis], device=dev)
    origins_l = _local(origins, mesh, axis)
    rgbs, alphas = [], []
    for b in range(B):
        o = order[b]
        m2, rd = proj.mean2d[b][o], proj.radius[b][o]
        rgb_t, alpha_t = _composite_local(
            origins_l, (m2, proj.conic[b][o], opacities[o]), colors[o],
            ok[b][o], m2, rd, _alpha_conic, tile_shape, tile_capacity, chunk,
            True, 0.5, compositor)
        rgbs.append(rgb_t)
        alphas.append(alpha_t)
    rgb_t = gather_strips(torch.stack(rgbs), mesh, axis, dim=1)
    alpha_t = gather_strips(torch.stack(alphas), mesh, axis, dim=1)

    T_real = n_ty * n_tx
    rgb = (rgb_t[:, :T_real].reshape(B, n_ty, n_tx, th, tw, 3)
           .permute(0, 1, 3, 2, 4, 5)
           .reshape(B, n_ty * th, n_tx * tw, 3)[:, :height, :width])
    alpha = (alpha_t[:, :T_real].reshape(B, n_ty, n_tx, th, tw)
             .permute(0, 1, 3, 2, 4)
             .reshape(B, n_ty * th, n_tx * tw)[:, :height, :width])
    if backgrounds is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * backgrounds.reshape(1, 1, 1, 3)
    if squeeze:
        rgb, alpha = rgb[0], alpha[0]
    return rgb, alpha


# ----------------------------------------------------------------------------
# Strip-halo windowed SSIM (no full-image gather).
# ----------------------------------------------------------------------------

def _ssim_band_partial(pred_t, tgt_t, mesh, tile_axis, n_tx, th, tw, H, W,
                       kernel_size=11, sigma=1.5, k1=0.01, k2=0.03,
                       data_range=1.0):
    """This rank's partial (sum, count) of the SSIM map over row-aligned
    tile strips.

    pred_t/tgt_t: [B, T_l, th·tw, 3] local strips forming a contiguous
    horizontal image band (``_padded_origins(row_aligned=True)``). Each
    rank evaluates the SSIM window positions whose top row lies in its
    band; the ``kernel_size − 1`` halo rows come from the next ranks by
    :func:`~pose_splatter_torch.parallel.comm.ppermute` (several hops when
    a band is shorter than the halo; ranks past the end receive zeros,
    their positions masked). The map values are those of
    ``ops/ssim.ssim``'s VALID filter (TF32 off); callers psum the
    partials over the tile axis and divide.
    """
    B, T_l, P, ch = pred_t.shape
    rows_l = T_l // n_tx
    bh = rows_l * th
    Wp = n_tx * tw
    halo = kernel_size - 1

    def band(x):
        return (x.reshape(B, rows_l, n_tx, th, tw, ch)
                .permute(0, 1, 3, 2, 4, 5).reshape(B, bh, Wp, ch))

    pb, tb = band(pred_t), band(tgt_t)
    idx = mesh.index(tile_axis)
    ext_p, ext_t = [pb], [tb]
    got = 0
    hop = 1
    while got < halo:
        take = min(bh, halo - got)
        ext_p.append(ppermute(pb[:, :take], mesh, tile_axis, hop))
        ext_t.append(ppermute(tb[:, :take], mesh, tile_axis, hop))
        got += take
        hop += 1
    pe = torch.cat(ext_p, dim=1)  # [B, bh+halo, Wp, ch]
    te = torch.cat(ext_t, dim=1)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kernel = _gaussian_kernel(kernel_size, sigma, pred_t.device)
    mu_x = _filter2d(pe, kernel)
    mu_y = _filter2d(te, kernel)
    sigma_xx = _filter2d(pe * pe, kernel) - mu_x * mu_x
    sigma_yy = _filter2d(te * te, kernel) - mu_y * mu_y
    sigma_xy = _filter2d(pe * te, kernel) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_xx + sigma_yy + c2)
    smap = num / den  # [B, bh, Wp - halo, ch]

    # Window positions inside the REAL image: top row <= H-k, left <= W-k.
    dev = pred_t.device
    g_rows = idx * bh + torch.arange(bh, device=dev)
    row_ok = g_rows <= H - kernel_size
    col_ok = torch.arange(Wp - halo, device=dev) <= W - kernel_size
    m = row_ok[None, :, None, None] & col_ok[None, None, :, None]
    total = torch.where(m, smap, torch.zeros_like(smap)).sum()
    count = m.to(torch.float32).sum() * B * ch
    return total, count


# ----------------------------------------------------------------------------
# (data, tile) 2D-mesh train step.
# ----------------------------------------------------------------------------

def make_tile_sharded_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    img_lambda: float,
    ssim_lambda: float,
    mesh: Mesh,
    data_axis: str = "data",
    tile_axis: str = "tile",
    tile_shape: Tuple[int, int] = (32, 128),
    tile_capacity: int = 2048,
    chunk: int = 32,
    compositor: str = "tiled",
):
    """Train step on a 2D ``(data, tile)`` mesh: ``step(state,
    local_batch) -> (state, loss)``, with this rank's frames of the
    ``data`` axis (``shard_batch(batch, mesh, data_axis)``).

    Each frame's render and photometric loss split its pixel tiles over
    ``tile`` (row-aligned, so each rank holds a band of the image); the
    carve, U-Nets and head run on every tile rank (train-mode BN; the new
    statistics are dropped and the running ones stay as they were, as the
    JAX step returns ``state.batch_stats``). The loss is averaged over
    ``data`` (the same on every rank), and the gradients over ``data`` and
    then over ``tile``, each in one flat bucket, before the optimizer step.
    """
    n_tile = mesh.shape[tile_axis]
    th, tw = tile_shape
    H, W = model.H, model.W
    dev = model.device
    origins, n_ty, n_tx, _ = _padded_origins(H, W, tile_shape, n_tile,
                                             row_aligned=True, device=dev)
    origins_l = _local(origins, mesh, tile_axis)
    alpha_fn = _alpha_conic if model.gaussian_mode == "3d" else _alpha_ellipse
    # This rank's tiles of the padded image: real tiles by index, pad
    # tiles read the appended zero tile.
    T_l = origins_l.shape[0]
    t0 = mesh.index(tile_axis) * T_l
    tile_ids = torch.clamp(torch.arange(t0, t0 + T_l, device=dev),
                           max=n_ty * n_tx)

    def strip_render(b, overflow):
        """One frame's Gaussians composited on this rank's tiles."""
        g, _ = model.frame_gaussians(b["mask"], b["img"], b["p_3d"],
                                     b["angle"], new_stats={})
        view = torch.as_tensor(b["view_idx"], device=dev).long()
        if model.gaussian_mode == "3d":
            g = model.apply_pose_transform_3d(g, b["angle"], b["p_3d"])
            proj = project_gaussians(
                g["means"], g["quats"], torch.exp(g["log_scales"]),
                model.viewmats[view], model.Ks[view], W, H)
            ok = proj.valid & g["valid"]
            keys = torch.where(ok, proj.depth,
                               torch.full_like(proj.depth, float("inf")))
            order = torch.sort(keys, stable=True).indices
            feats = (proj.mean2d[order], proj.conic[order],
                     torch.sigmoid(g["logit_opacities"])[order])
            cols = g["colors"][order]
            center, radius, okk = feats[0], proj.radius[order], ok[order]
            early, offset = True, 0.5
        else:
            means2d = g["means2d"]
            if "anchor_means" in g:
                # View-anchored 2D: means2d is a pixel delta from the view's
                # projection of the pose-transformed voxel anchor.
                rot = yaw_rotation(model._tensor(b["angle"]))
                anchors = g["anchor_means"] @ rot.T + model._tensor(b["p_3d"])
                pix = project_points(anchors, model.Ks[view][None],
                                     model.viewmats[view][None],
                                     clamp_z=True)[0]
                means2d = pix + means2d
            sc = torch.exp(g["log_scales2d"])
            radius = model.sigma_cutoff * torch.maximum(sc[:, 0], sc[:, 1])
            feats = (means2d, sc, g["rotation"],
                     torch.sigmoid(g["logit_opacities"]))
            cols = g["colors"]
            center, okk = means2d, g["valid"]
            early, offset = False, 0.0
        rgb_t, alpha_t = _composite_local(
            origins_l, feats, cols, okk, center, radius, alpha_fn,
            tile_shape, tile_capacity, chunk, early, offset, compositor,
            overflow)
        rgb_t = rgb_t + (1.0 - alpha_t[..., None]) * model.background_color
        return rgb_t, alpha_t  # [T_l, th*tw, 3], [T_l, th*tw]

    def target_strips(img2d):
        """This rank's tile strips of a target image [H, W, ...]."""
        extra = img2d.shape[2:]
        pad = [0, 0] * len(extra) + [0, n_tx * tw - W, 0, n_ty * th - H]
        full = torch.nn.functional.pad(img2d, pad)
        tiles = (full.reshape((n_ty, th, n_tx, tw) + extra)
                 .permute((0, 2, 1, 3) + tuple(range(4, 4 + len(extra))))
                 .reshape((n_ty * n_tx, th * tw) + extra))
        tiles = torch.cat([tiles, tiles.new_zeros((1,) + tiles.shape[1:])])
        return tiles[tile_ids]

    def local_loss(frames, overflow):
        rgbs, tgts, parts = [], [], []
        for b in frames:
            rgb_t, alpha_t = strip_render(b, overflow)
            obs = torch.as_tensor(b["obs_idx"], device=dev).reshape(1).long()
            tgt_img = target_strips(model._tensor(b["img"]).index_select(0, obs)[0])
            tgt_mask = target_strips(
                model._tensor(b["mask"]).index_select(0, obs)[0])
            # Strip-local partial sums → whole-image losses via psum(tile).
            parts.append(torch.stack([
                (alpha_t * tgt_mask).sum(),
                (alpha_t + tgt_mask - alpha_t * tgt_mask).sum(),
                (tgt_img - rgb_t).abs().sum(), tgt_mask.sum()]))
            rgbs.append(rgb_t)
            tgts.append(tgt_img)
        inter, union, l1n, msum = psum(torch.stack(parts), mesh,
                                       tile_axis).unbind(1)
        iou = 1.0 - (inter + 1e-6) / (union + 1e-6)
        l1 = l1n / torch.clamp(msum, min=1.0)
        loss = iou.mean() + img_lambda * l1.mean()
        if ssim_lambda:
            s_sum, s_cnt = _ssim_band_partial(
                torch.stack(rgbs), torch.stack(tgts), mesh, tile_axis, n_tx,
                th, tw, H, W)
            s = psum(torch.stack([s_sum, s_cnt]), mesh, tile_axis)
            loss = loss + ssim_lambda * (1.0 - s[0] / s[1])
        # Mean over the global frame batch.
        return pmean(loss, mesh, data_axis)

    def step(state, batch):
        frames = [{k: v[i] for k, v in batch.items()}
                  for i in range(len(batch["angle"]))]
        optimizer.zero_grad(set_to_none=True)
        overflow = []
        loss = local_loss(frames, overflow)
        loss.backward()
        grads = [p.grad for p in model.net.parameters() if p.grad is not None]
        reduced = mean_over(mean_over(grads, mesh, data_axis), mesh, tile_axis)
        for g, r in zip(grads, reduced):
            g.copy_(r)
        optimizer.step()
        # Gaussians dropped by the tiles' capacity: each frame's whole
        # image, meaned over the global batch (the train step's metric).
        total = psum(torch.stack(overflow).sum().float(), mesh, tile_axis)
        step.overflow = pmean(total / len(frames), mesh, data_axis)
        model.check_selection()
        return state._replace(step=state.step + 1), loss.detach()

    step.overflow = None
    return step
