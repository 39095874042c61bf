"""Instance binning and the forward and backward compositors (counterpart
of ``pose_splatter_tpu/ops/rasterize_pallas.py``).

Host side (plain PyTorch): each Gaussian is duplicated once per pixel tile
its binning circle touches, and the copies are laid out in one flat array,
grouped by tile in compositing order, each tile's segment padded to a
multiple of G rows (``_build_instances``, ``gather_instances``). Two finite
capacities are truncated and COUNTED, never silent: Gaussians spanning more
than ``expand`` tiles (and each Gaussian's span is returned, so that a
trace can count the Gaussians clamped), and segment rows past the array's
``mcap`` rows.
``gather_instances``' backward reduces instance-row gradients back onto the
Gaussians with a gather, as the JAX package's custom VJP does, and
``permute_rows`` (the 3D depth order) gathers by the inverse permutation.

Device side: :func:`composite_instances` walks each tile's segment and can
store each chunk's entry transmittance; :func:`composite_instances_bwd`
walks the segments back to front from those stores and writes each
instance row's gradient. On a CUDA tensor each launches its hand-written
kernel (``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``); on a CPU
tensor it runs its plain PyTorch version (``composite_instances_ref``,
``composite_instances_bwd_ref``). There is no fallback between the two.
The kernels spread each tile's chunks over blocks of their own and carry
the transmittance forward and the suffix backward between them by
per-pixel scans. Their first phase (``csrc/composite_common.cuh``) tells
each chunk of the instance array its tile; :func:`chunk_map` is its plain
version. :func:`composite_with_grad` joins them into an autograd function.

Feature packing (16 float32 columns per row):
    conic / 3D:   0 mean_x  1 mean_y  2 conic_a  3 conic_b  4 conic_c
                  6 opacity  7..9 rgb  10 binning radius
    ellipse / 2D: 0 mean_x  1 mean_y  2 cos(theta)  3 sin(theta)  4 sx
                  5 sy  6 opacity  7..9 rgb  10 binning radius
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pose_splatter_torch.utils import stages

ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
STOP_T = 1e-4
# Pixel centres per mode: integer coordinates in 2D (ellipse), +0.5 in 3D
# (conic). Conic mode also gates contributions and stops early at STOP_T.
PIXEL_OFFSET = {"ellipse": 0.0, "conic": 0.5}

F = 16  # packed feature columns (one 64-byte row)

# Max tiles one Gaussian may be duplicated into (library default; the model
# uses 16). Spans beyond it are truncated and counted.
DEFAULT_EXPAND = 8


def pack_conic(mean2d, conic, opacity, colors, radius):
    """[.., 2],[.., 3],[..],[.., 3],[..] -> [.., 16] packed features."""
    pads = torch.zeros(mean2d.shape[:-1] + (F - 11,), dtype=mean2d.dtype,
                       device=mean2d.device)
    return torch.cat([
        mean2d, conic, torch.zeros_like(opacity[..., None]),
        opacity[..., None], colors, radius[..., None], pads,
    ], dim=-1)


def pack_ellipse(mean2d, scales2d, theta, opacity, colors, radius):
    pads = torch.zeros(mean2d.shape[:-1] + (F - 11,), dtype=mean2d.dtype,
                       device=mean2d.device)
    return torch.cat([
        mean2d, torch.cos(theta)[..., None], torch.sin(theta)[..., None],
        scales2d, opacity[..., None], colors, radius[..., None], pads,
    ], dim=-1)


def instance_rows(N: int, T: int, expand: int, G: int,
                  cap: int | None = None) -> int:
    """Row count of one camera's instance array: worst-case aligned
    segments (every Gaussian in ``expand`` tiles + per-tile alignment
    padding), optionally bounded by ``cap`` rows (overflow is counted)."""
    worst = -(-(N * expand) // G) * G + T * G
    if cap is None:
        return worst
    return min(worst, -(-cap // G) * G)


def _build_instances(center, radius, valid, n_ty: int, n_tx: int,
                     tile_shape: Tuple[int, int], expand: int, G: int,
                     mcap: int):
    """Bin a batch of cameras' Gaussians into per-tile instance slots.

    center [B,N,2], radius [B,N], valid [B,N] bool; Gaussians already in
    compositing order. Per camera this returns what the JAX function
    returns for that camera:

        dest     [B, N*expand] int64: instance row per slot (rows >= mcap,
                 including every dead slot, are dropped by the gather);
        src      [B, N*expand] int64: source Gaussian;
        astarts  [B, T] int32: each tile's first row (multiple of G);
        counts   [B, T] int32: per-tile instance count (capacity-clamped);
        overflow [B] int64: instances dropped by either cap;
        span     [B, N] int64: tiles each Gaussian's circle spans, before
                 the ``expand`` clamp (0 off the image).

    A slot's row is its tile's start plus the number of earlier Gaussians
    that hit the same tile. The JAX code takes that from an exclusive
    cumsum of an [N, T] one-hot; here a stable sort of the slots by tile
    gives the same rank without the [N, T] matrices.
    """
    th, tw = tile_shape
    T = n_ty * n_tx
    B, N = radius.shape
    dev = radius.device
    cx, cy = center[..., 0], center[..., 1]
    r = torch.where(valid, radius, torch.zeros_like(radius))
    overlap = (
        valid
        & (cx + r >= 0) & (cx - r < n_tx * tw)
        & (cy + r >= 0) & (cy - r < n_ty * th)
    )
    # Culled (NaN/inf) centers fail the overlap test; zero them so the span
    # arithmetic below stays finite.
    cx = torch.where(overlap, cx, torch.zeros_like(cx))
    cy = torch.where(overlap, cy, torch.zeros_like(cy))
    x0t = torch.clamp(torch.floor((cx - r) / tw), 0, n_tx - 1).long()
    x1t = torch.clamp(torch.floor((cx + r) / tw), 0, n_tx - 1).long()
    y0t = torch.clamp(torch.floor((cy - r) / th), 0, n_ty - 1).long()
    y1t = torch.clamp(torch.floor((cy + r) / th), 0, n_ty - 1).long()
    wspan = torch.clamp(x1t - x0t + 1, min=1)
    hspan = torch.clamp(y1t - y0t + 1, min=1)
    span = torch.where(overlap, wspan * hspan, torch.zeros_like(wspan))
    span_c = torch.clamp(span, max=expand)
    overflow_span = (span - span_c).sum(dim=1)

    # Slot e of a Gaussian is the e-th tile of its rectangle in row-major
    # order; only the first min(span, expand) slots are live.
    e = torch.arange(expand, device=dev)
    ok = e < span_c[..., None]  # [B,N,E]
    ty = y0t[..., None] + e // wspan[..., None]
    tx = x0t[..., None] + e % wspan[..., None]
    tile = ty * n_tx + tx
    cam = torch.arange(B, device=dev)[:, None, None]
    gtile = torch.where(ok, cam * T + tile, torch.full_like(tile, B * T))
    flat = gtile.reshape(-1)  # slot order (camera, Gaussian, e)

    # Counts by tile, the dead slots' count last; a fixed-size count (a
    # bincount sizes its output by the maximum, a read-back on the card).
    counts_all = torch.zeros(B * T + 1, dtype=torch.long, device=dev)
    counts_all.index_add_(0, flat, torch.ones_like(flat))
    counts = counts_all[:B * T].reshape(B, T)
    nsteps = (counts + G - 1) // G
    astarts = G * torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=dev),
         torch.cumsum(nsteps, dim=1)], dim=1)  # [B, T+1]

    rank = _slot_rank(flat, counts_all).reshape(B, N, expand)

    tile_c = torch.where(ok, tile, torch.zeros_like(tile))
    row = torch.gather(astarts, 1, tile_c.reshape(B, -1)).reshape(B, N, expand)
    row = row + rank

    # Capacity clamp: tiles whose aligned segment spills past mcap lose
    # the spilled tail (counted); astarts stays in range.
    avail = torch.clamp(mcap - astarts[:, :T], min=0)
    counts_c = torch.minimum(counts, avail)
    overflow_cap = (counts - counts_c).sum(dim=1)
    astarts_c = torch.clamp(astarts[:, :T], max=max(mcap - G, 0))

    gid = torch.arange(N, device=dev)[None, :, None]
    dest = torch.where(ok, row, mcap + gid * expand + e)
    src = torch.where(ok, gid.expand_as(row), torch.zeros_like(row))
    return (dest.reshape(B, -1), src.reshape(B, -1),
            astarts_c.to(torch.int32), counts_c.to(torch.int32),
            overflow_span + overflow_cap, span)


def _slot_rank(flat: torch.Tensor, counts_all: torch.Tensor) -> torch.Tensor:
    """Each slot's rank among the earlier slots of its tile: flat [K] tile
    ids (slot order), counts_all [n] slots a tile id. A stable sort of the
    slots by tile, each sorted slot's offset from its tile's first, and a
    scatter back by the sort's permutation (the JAX code reads the rank off
    an exclusive cumsum of an [N, T] one-hot, ``_excl_cumsum_mxu``)."""
    sorted_tiles, perm = torch.sort(flat, stable=True)
    group_start = torch.cumsum(counts_all, 0) - counts_all
    rank_sorted = (torch.arange(flat.numel(), device=flat.device)
                   - group_start[sorted_tiles])
    rank = torch.empty_like(rank_sorted)
    rank[perm] = rank_sorted  # perm is a permutation: unique indices
    return rank


def _invert_slots(dest: torch.Tensor, src: torch.Tensor, n: int,
                  mcap: int) -> torch.Tensor:
    """inv [B, mcap] with inv[b, dest[b, k]] = src[b, k] where dest < mcap,
    else n (``rasterize_pallas.py:299-303``). One scatter whose indices are
    unique and in range: each dropped slot k writes its own dump column
    ``mcap + k``, which is cut off afterwards."""
    B, M = dest.shape
    keep = dest < mcap
    idx = torch.where(keep, dest, mcap + torch.arange(M, device=dest.device))
    inv = torch.full((B, mcap + M), n, dtype=torch.long, device=dest.device)
    inv.scatter_(1, idx, src)
    return inv[:, :mcap]


class _GatherInstances(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, dest, src, mcap):
        B, N, nf = packed.shape
        inv = _invert_slots(dest, src, N, mcap)
        padded = torch.cat([packed, torch.zeros(
            (B, 1, nf), dtype=packed.dtype, device=packed.device)], 1)
        ctx.save_for_backward(dest)
        ctx.mcap, ctx.n = mcap, N
        return torch.gather(padded, 1, inv[..., None].expand(-1, -1, nf))

    @staticmethod
    def backward(ctx, dinst):
        (dest,) = ctx.saved_tensors
        B, nf = dinst.shape[0], dinst.shape[-1]
        dpad = torch.cat([dinst, torch.zeros((B, 1, nf), dtype=dinst.dtype,
                                             device=dinst.device)], 1)
        rows = torch.where(dest < ctx.mcap, dest, torch.full_like(dest, ctx.mcap))
        full = torch.gather(dpad, 1, rows[..., None].expand(-1, -1, nf))
        # Slots are laid out (Gaussian, e): sum each Gaussian's slots.
        return full.reshape(B, ctx.n, -1, nf).sum(2), None, None, None


def gather_instances(packed: torch.Tensor, dest: torch.Tensor,
                     src: torch.Tensor, mcap: int) -> torch.Tensor:
    """[B,N,F] packed Gaussians → [B,mcap,F] instance arrays (padding rows
    all-zero). Slot k goes to row ``dest[k]`` from Gaussian ``src[k]``;
    rows >= mcap are dropped.

    The slot map is inverted by :func:`_invert_slots`, then the rows are
    gathered.

    Backward (``rasterize_pallas.py:306-324``): ``dpacked[n] = Σ_e
    dinst[dest[n, e]]``, a gather with dead slots reading an appended zero
    row, then a sum over each Gaussian's ``expand`` slots. ``torch.gather``'s
    own backward would be a scatter-add with atomics over duplicate
    indices, whose order on the card changes from run to run.
    """
    return _GatherInstances.apply(packed, dest, src, mcap)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(order)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        return g.index_select(0, inv), None


def permute_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[order]`` for a permutation ``order`` of x's rows
    (``rasterize_pallas.py:246-269``). The backward gathers the gradient by
    the inverse permutation, built by one scatter of unique indices, where
    indexing's own backward would be a scatter-add."""
    return _PermuteRows.apply(x, order)


# ----------------------------------------------------------------------------
# The compositor: plain version and kernel wrapper.
# ----------------------------------------------------------------------------

def _chunk_alpha(mode: str, f: torch.Tensor, xs: torch.Tensor,
                 ys: torch.Tensor, rowmask: torch.Tensor):
    """Alpha [A,G,P] for chunks f [A,G,16] at pixels xs, ys [A,1,P], and
    what the backward needs of it (``rasterize_pallas.py:341-376``)."""
    dx = xs - f[..., 0:1]
    dy = ys - f[..., 1:2]
    opacity = f[..., 6:7]
    if mode == "conic":
        A, B, C = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
        e = torch.exp(-sigma)
        raw = opacity * e
        a = torch.clamp(raw, max=ALPHA_CLAMP)
        live = (sigma >= 0) & (raw >= ALPHA_SKIP) & rowmask
        flow = live & (raw < ALPHA_CLAMP)  # the gradient passes the clamp
        return torch.where(live, a, torch.zeros_like(a)), (dx, dy, e, raw, flow)
    c, s = f[..., 2:3], f[..., 3:4]
    sx, sy = f[..., 4:5], f[..., 5:6]
    u = c * dx + s * dy
    v = -s * dx + c * dy
    sx2 = 2.0 * sx * sx + 1e-8
    sy2 = 2.0 * sy * sy + 1e-8
    e = torch.exp(-(u * u / sx2 + v * v / sy2))
    a = torch.where(rowmask, opacity * e, torch.zeros_like(e))
    return a, (dx, dy, u, v, e, sx2, sy2)


def _pixels(origins, tile_shape, mode, dev):
    """Pixel coordinates xs, ys [T, P] of every tile."""
    th, tw = tile_shape
    pidx = torch.arange(th * tw, device=dev)
    off = PIXEL_OFFSET[mode]
    xs = (origins[:, 1:2].float() + (pidx % tw).float()) + off
    ys = (origins[:, 0:1].float() + (pidx // tw).float()) + off
    return xs, ys


def composite_instances_ref(inst, astarts, counts, origins,
                            tile_shape: Tuple[int, int], chunk: int,
                            mode: str, save_tbounds: bool = False):
    """Plain PyTorch version of the forward compositor.

    inst [R,16] f32; astarts, counts [T] int; origins [T,2] int (y0, x0).
    Walks every tile's segment in chunks of ``chunk`` rows, all live tiles
    at once: T = T_in · exclusive cumprod(1 − a) within the chunk and, in
    conic mode, the gate T·(1 − a) ≥ 1e-4 and the stop once no pixel of a
    tile has T ≥ 1e-4. Returns rgb [T,3,P], alpha [T,P], jstop [T] int32,
    and with ``save_tbounds`` also tbounds [R/chunk, P]: each walked
    chunk's entry T (row astarts/chunk + j), zero elsewhere.
    """
    early_stop = mode == "conic"
    th, tw = tile_shape
    P = th * tw
    G = chunk
    nt = astarts.shape[0]
    dev = inst.device
    astarts = astarts.long()
    counts = counts.long()
    xs, ys = _pixels(origins, tile_shape, mode, dev)
    t_in = torch.ones((nt, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((nt, 4, P), dtype=torch.float32, device=dev)
    jstop = torch.zeros((nt,), dtype=torch.int32, device=dev)
    tbounds = (torch.zeros((inst.shape[0] // G, P), dtype=torch.float32,
                           device=dev) if save_tbounds else None)
    n_steps = (counts + G - 1) // G
    live = n_steps > 0
    rows_g = torch.arange(G, device=dev)
    for j in range(int(n_steps.max()) if nt else 0):
        act = torch.nonzero(live & (n_steps > j)).reshape(-1)
        if act.numel() == 0:
            break
        if save_tbounds:
            tbounds[astarts[act] // G + j] = t_in[act]
        rowmask = rows_g[None, :] < (counts[act] - j * G)[:, None]  # [A,G]
        rows = astarts[act, None] + j * G + rows_g[None, :]
        f = inst[torch.where(rowmask, rows, torch.zeros_like(rows))]  # [A,G,16]
        a, _ = _chunk_alpha(mode, f, xs[act, None, :], ys[act, None, :],
                            rowmask[..., None])  # [A,G,P]
        cp = torch.cumprod(1.0 - a, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        T = t_in[act, None, :] * excl
        contrib = a * T
        if early_stop:
            contrib = torch.where(T * (1.0 - a) >= STOP_T, contrib,
                                  torch.zeros_like(contrib))
        acc[act] += torch.stack([
            (contrib * f[..., 7:8]).sum(1), (contrib * f[..., 8:9]).sum(1),
            (contrib * f[..., 9:10]).sum(1), contrib.sum(1)], dim=1)
        t_out = t_in[act] * cp[:, -1]
        t_in[act] = t_out
        jstop[act] = j + 1
        if early_stop:
            live[act] = t_out.amax(dim=1) >= STOP_T
    if save_tbounds:
        return acc[:, :3], acc[:, 3], jstop, tbounds
    return acc[:, :3], acc[:, 3], jstop


def composite_instances_bwd_ref(inst, tbounds, astarts, counts, origins,
                                jstop, g_rgb, g_alpha,
                                tile_shape: Tuple[int, int], chunk: int,
                                mode: str):
    """Plain PyTorch version of the backward compositor (the math of
    ``_bwd_kernel``, ``rasterize_pallas.py:528-672``).

    One reverse sweep per tile over its walked chunks ``jstop−1 … 0``, all
    tiles at once. Each chunk recomputes a and T from its stored entry T
    (no division to rebuild T), with w = ⟨g_rgb, rgb⟩ + g_alpha and the
    strict suffix S_i = sfx + (Σ_chunk w·contrib − inclusive cumsum_i),
    dL/da = w·T·keep − S/(1 − a), then the per-mode chain to the packed
    features (``:603-651``). Returns dinst [R,16]: rows never walked stay
    zero, as do columns 5 (conic) and 10-15.
    """
    early_stop = mode == "conic"
    G = chunk
    nt = astarts.shape[0]
    dev = inst.device
    astarts = astarts.long()
    counts = counts.long()
    jstop = jstop.long()
    xs, ys = _pixels(origins, tile_shape, mode, dev)
    dinst = torch.zeros_like(inst)
    sfx = torch.zeros_like(g_alpha)
    rows_g = torch.arange(G, device=dev)
    for jj in range(int(jstop.max()) if nt else 0):
        act = torch.nonzero(jstop > jj).reshape(-1)
        j = jstop[act] - 1 - jj  # each tile's own reverse chunk
        rowmask = rows_g[None, :] < (counts[act] - j * G)[:, None]  # [A,G]
        rows = astarts[act, None] + j[:, None] * G + rows_g[None, :]
        f = inst[torch.where(rowmask, rows, torch.zeros_like(rows))]  # [A,G,16]
        T_in = tbounds[astarts[act] // G + j][:, None, :]  # [A,1,P]
        a, aux = _chunk_alpha(mode, f, xs[act, None, :], ys[act, None, :],
                              rowmask[..., None])
        cp = torch.cumprod(1.0 - a, dim=1)
        T = T_in * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        if early_stop:
            keep = (T * (1.0 - a) >= STOP_T).float()
        else:
            keep = torch.ones_like(a)
        contrib = a * T * keep
        g_r, g_g, g_b = (g_rgb[act, c, None, :] for c in range(3))
        g_a = g_alpha[act, None, :]
        w = g_r * f[..., 7:8] + g_g * f[..., 8:9] + g_b * f[..., 9:10] + g_a
        wc = w * contrib
        tot = wc.sum(1, keepdim=True)
        s_i = sfx[act, None, :] + (tot - torch.cumsum(wc, dim=1))
        da = w * T * keep - s_i / (1.0 - a)
        dcol = [(g * contrib).sum(2) for g in (g_r, g_g, g_b)]
        if mode == "conic":
            dx, dy, e, raw, flow = aux
            da_f = da * flow.float()
            dop = (e * da_f).sum(2)
            dsigma = -raw * da_f
            A, B, C = f[..., 2:3], f[..., 3:4], f[..., 4:5]
            grads = [
                (-(A * dx + B * dy) * dsigma).sum(2),
                (-(C * dy + B * dx) * dsigma).sum(2),
                (0.5 * dx * dx * dsigma).sum(2), (dx * dy * dsigma).sum(2),
                (0.5 * dy * dy * dsigma).sum(2), torch.zeros_like(dop), dop]
        else:
            dx, dy, u, v, e, sx2, sy2 = aux
            da_m = da * rowmask[..., None].float()
            dop = (e * da_m).sum(2)
            dE = f[..., 6:7] * da_m
            du = dE * (e * (-2.0 * u / sx2))
            dv = dE * (e * (-2.0 * v / sy2))
            c_, s_ = f[..., 2:3], f[..., 3:4]
            grads = [
                (-(du * c_ - dv * s_)).sum(2), (-(du * s_ + dv * c_)).sum(2),
                (du * dx + dv * dy).sum(2), (du * dy - dv * dx).sum(2),
                (dE * e * (u * u / (sx2 * sx2))).sum(2) * 4.0 * f[..., 4],
                (dE * e * (v * v / (sy2 * sy2))).sum(2) * 4.0 * f[..., 5],
                dop]
        grads = torch.stack(grads + dcol, dim=-1)  # [A,G,10]
        dinst[rows[rowmask], :10] = grads[rowmask]  # each row once
        sfx[act] += tot[:, 0]
    return dinst


def chunk_map(astarts, counts, n_rows: int, chunk: int):
    """Which tile each chunk of an instance array belongs to: the plain
    version of phase 0 of both compositor kernels
    (``csrc/composite_common.cuh``: one block a tile writes its chunks'
    entries over a map filled with −1, in scratch of the kernel's own).

    astarts, counts [T] int (astarts multiples of ``chunk``, non-empty
    segments disjoint, as :func:`_build_instances` lays them out); n_rows
    the array's rows, a multiple of ``chunk``. Returns, on the inputs'
    device:

        chunk_tile [n_rows/chunk] int32: the tile whose segment holds
                   chunk c (rows [c·chunk, (c+1)·chunk)), or −1 (padding);
        chunk_j    [n_rows/chunk] int32: the chunk's index in that segment,
                   or −1;
        rows       [T] int32: each segment's rows inside the array (0 for a
                   segment that starts outside it, cut at its end).

    Each non-empty tile's start chunk is scattered to a map of its own
    (empty tiles to distinct dump slots past the end, so the indices are
    unique), a running maximum carries the latest start forward over the
    chunks, and a chunk past its tile's last one maps to −1.
    """
    G = chunk
    nc = n_rows // G
    nt = astarts.shape[0]
    dev = astarts.device
    start = astarts.long()
    cnt = counts.long()
    inside = (start >= 0) & (start < n_rows) & (cnt > 0)
    rows = torch.where(inside, torch.minimum(cnt, n_rows - start),
                       torch.zeros_like(cnt))
    first = torch.where(rows > 0, start // G,
                        nc + torch.arange(nt, device=dev))
    head = torch.full((nc + nt,), -1, dtype=torch.long, device=dev)
    head.scatter_(0, first, torch.arange(nt, device=dev))
    c = torch.arange(nc, device=dev)
    last = torch.cummax(torch.where(head[:nc] >= 0, c, -1), 0).values
    tile = head[last.clamp(min=0)]
    j = c - first[tile.clamp(min=0)]
    live = (last >= 0) & (j < (rows[tile.clamp(min=0)] + G - 1) // G)
    none = torch.full_like(c, -1)
    return (torch.where(live, tile, none).int(),
            torch.where(live, j, none).int(), rows.int())


def scratch_bytes(n_rows: int, n_tiles: int, chunk: int,
                  tile_shape: Tuple[int, int], backward: bool = False) -> int:
    """Device scratch one kernel call allocates beside its outputs: the
    chunk map (two int32 a chunk and one a tile), then the forward's ``cp``
    (which holds the entry T on the eval path) and partial sums
    [R/G, 4, P], or the backward's ``tot`` and ``sfx`` [R/G, P] each."""
    nc = n_rows // chunk
    P = tile_shape[0] * tile_shape[1]
    per_chunk = (2 if backward else 5) * P * 4
    return nc * (8 + per_chunk) + 4 * n_tiles


def _kernel_fn(name: str, n_ptrs: int):
    """The C entry ``name`` of ``csrc/<name>.cu``: (inst, n_rows, then
    ``n_ptrs`` pointers, n_tiles, th, tw, G, conic, stream)."""
    from pose_splatter_torch.ops import _build

    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, ctypes.c_longlong] + [p] * n_ptrs
                       + [ctypes.c_int] * 5 + [p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tile(tile_shape: Tuple[int, int], chunk: int,
               max_chunk: int = 768) -> None:
    """Raise unless the kernels take this tile and chunk: at most 1024
    pixels a tile, chunks of 1 to ``max_chunk`` rows (768 forward, 512
    backward: the backward's shared memory holds 384 bytes a row)."""
    if tile_shape[0] * tile_shape[1] > 1024 or not 0 < chunk <= max_chunk:
        raise ValueError(f"tile {tile_shape} / chunk {chunk} not supported "
                         f"(P <= 1024 pixels, chunk <= {max_chunk} rows)")


def _check_launch(inst, astarts, counts, origins, tile_shape, chunk,
                  max_chunk):
    """Checks the kernels share; returns (R, T, P)."""
    P = tile_shape[0] * tile_shape[1]
    nt = astarts.shape[0]
    R = inst.shape[0]
    dev = inst.device
    _check("inst", inst, torch.float32, (R, F), dev)
    _check("astarts", astarts, torch.int32, (nt,), dev)
    _check("counts", counts, torch.int32, (nt,), dev)
    _check("origins", origins, torch.int32, (nt, 2), dev)
    if R % chunk:
        raise ValueError(f"instance rows {R} not a multiple of chunk {chunk}")
    check_tile(tile_shape, chunk, max_chunk)
    if inst.data_ptr() % 16:
        raise ValueError("inst must be 16-byte aligned")
    return R, nt, P


def composite_instances(inst, astarts, counts, origins,
                        tile_shape: Tuple[int, int], chunk: int, mode: str,
                        save_tbounds: bool = False):
    """Composite per-tile instance segments in ``"ellipse"`` (2D) or
    ``"conic"`` (3D) mode.

    inst [R,16] float32 (R a multiple of ``chunk``); astarts, counts [T]
    int32 (astarts multiples of ``chunk``); origins [T,2] int32 (y0, x0).
    Returns rgb [T,3,P], alpha [T,P], jstop [T] int32 (chunks walked per
    tile), and with ``save_tbounds`` tbounds [R/chunk, P] (each walked
    chunk's entry transmittance, for :func:`composite_instances_bwd`).

    CPU tensors run :func:`composite_instances_ref`; CUDA tensors launch
    ``csrc/composite_fwd.cu`` (built at first use; a memset and five
    kernels, one block a chunk of the array or a tile, see its source) and
    count the call in ``composite_instances.launches``. Non-empty segments
    must be disjoint, as the binning lays them out.
    """
    if mode not in ("conic", "ellipse"):
        raise ValueError(f"unknown mode {mode!r}")
    if inst.device.type == "cpu":
        return composite_instances_ref(inst, astarts, counts, origins,
                                       tile_shape, chunk, mode, save_tbounds)
    if inst.device.type != "cuda":
        raise ValueError(f"unsupported device {inst.device}")
    R, nt, P = _check_launch(inst, astarts, counts, origins, tile_shape,
                             chunk, max_chunk=768)
    dev = inst.device
    rgb = torch.empty((nt, 3, P), dtype=torch.float32, device=dev)
    alpha = torch.empty((nt, P), dtype=torch.float32, device=dev)
    jstop = torch.empty((nt,), dtype=torch.int32, device=dev)
    tbounds = (torch.zeros((R // chunk, P), dtype=torch.float32, device=dev)
               if save_tbounds else None)
    out = (rgb, alpha, jstop, tbounds) if save_tbounds else (rgb, alpha, jstop)
    if nt == 0:
        return out  # nothing to launch, nothing counted
    nc = R // chunk
    scratch = torch.empty(2 * nc + nt, dtype=torch.int32, device=dev)  # map
    cp = torch.empty((nc, P), dtype=torch.float32, device=dev)
    part = torch.empty((nc, 4, P), dtype=torch.float32, device=dev)
    fn = _kernel_fn("composite_fwd", 10)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(inst.data_ptr(), R, astarts.data_ptr(), counts.data_ptr(),
                 origins.data_ptr(), scratch.data_ptr(), rgb.data_ptr(),
                 alpha.data_ptr(), jstop.data_ptr(),
                 tbounds.data_ptr() if save_tbounds else None, cp.data_ptr(),
                 part.data_ptr(), nt, tile_shape[0], tile_shape[1], chunk,
                 int(mode == "conic"), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_instances.launches += 1
    return out


composite_instances.launches = 0


def composite_instances_bwd(inst, tbounds, astarts, counts, origins, jstop,
                            g_rgb, g_alpha, tile_shape: Tuple[int, int],
                            chunk: int, mode: str):
    """Instance-row gradients [R,16] of a composite, from the forward's
    ``tbounds`` and ``jstop`` and the loss gradients g_rgb [T,3,P],
    g_alpha [T,P] (other arguments as :func:`composite_instances`).

    CPU tensors run :func:`composite_instances_bwd_ref`; CUDA tensors
    launch ``csrc/composite_bwd.cu`` (built at first use; a memset and four
    kernels, see its source) and count the call in
    ``composite_instances_bwd.launches``.
    """
    if mode not in ("conic", "ellipse"):
        raise ValueError(f"unknown mode {mode!r}")
    if inst.device.type == "cpu":
        return composite_instances_bwd_ref(inst, tbounds, astarts, counts,
                                           origins, jstop, g_rgb, g_alpha,
                                           tile_shape, chunk, mode)
    if inst.device.type != "cuda":
        raise ValueError(f"unsupported device {inst.device}")
    # Shared memory a block: chunk rows plus 8 warps' partials of 10
    # gradients a row, 384 bytes a row, within the card's 227 KB.
    R, nt, P = _check_launch(inst, astarts, counts, origins, tile_shape,
                             chunk, max_chunk=512)
    dev = inst.device
    _check("tbounds", tbounds, torch.float32, (R // chunk, P), dev)
    _check("jstop", jstop, torch.int32, (nt,), dev)
    _check("g_rgb", g_rgb, torch.float32, (nt, 3, P), dev)
    _check("g_alpha", g_alpha, torch.float32, (nt, P), dev)
    dinst = torch.zeros_like(inst)
    if nt == 0:
        return dinst  # nothing to launch, nothing counted
    nc = R // chunk
    scratch = torch.empty(2 * nc + nt, dtype=torch.int32, device=dev)  # map
    tot = torch.empty((nc, P), dtype=torch.float32, device=dev)
    sfx = torch.empty_like(tot)
    fn = _kernel_fn("composite_bwd", 11)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(inst.data_ptr(), R, tbounds.data_ptr(), astarts.data_ptr(),
                 counts.data_ptr(), origins.data_ptr(), jstop.data_ptr(),
                 g_rgb.data_ptr(), g_alpha.data_ptr(), scratch.data_ptr(),
                 dinst.data_ptr(), tot.data_ptr(), sfx.data_ptr(), nt,
                 tile_shape[0], tile_shape[1], chunk, int(mode == "conic"),
                 stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    composite_instances_bwd.launches += 1
    return dinst


composite_instances_bwd.launches = 0
stages.count_launches("composite_fwd", composite_instances)
stages.count_launches("composite_bwd", composite_instances_bwd)


class _Composite(torch.autograd.Function):
    """Forward with the ``tbounds`` store, backward by the backward
    compositor (``_make_compositor``, ``rasterize_pallas.py:789-822``)."""

    @staticmethod
    def forward(ctx, inst, astarts, counts, origins, tile_shape, chunk, mode):
        rgb, alpha, jstop, tbounds = composite_instances(
            inst, astarts, counts, origins, tile_shape, chunk, mode,
            save_tbounds=True)
        ctx.save_for_backward(inst, tbounds, astarts, counts, origins, jstop)
        ctx.cfg = (tile_shape, chunk, mode)
        return rgb, alpha

    @staticmethod
    def backward(ctx, g_rgb, g_alpha):
        stages.end("loss_bwd", then="kernel_bwd")
        inst, tbounds, astarts, counts, origins, jstop = ctx.saved_tensors
        args = (inst, tbounds, astarts, counts, origins, jstop,
                g_rgb.contiguous(), g_alpha.contiguous()) + ctx.cfg
        dinst = composite_instances_bwd(*args)
        stages.end("kernel_bwd", tuple(
            a.detach() if torch.is_tensor(a) else a for a in args),
            then="backward")
        return dinst, None, None, None, None, None, None


def composite_with_grad(inst, astarts, counts, origins,
                        tile_shape: Tuple[int, int], chunk: int, mode: str):
    """rgb [T,3,P], alpha [T,P] of :func:`composite_instances`,
    differentiable in ``inst``. The forward stores ``tbounds`` only when a
    gradient is needed; otherwise it is the plain forward."""
    if torch.is_grad_enabled() and inst.requires_grad:
        return _Composite.apply(inst, astarts, counts, origins, tile_shape,
                                chunk, mode)
    return composite_instances(inst, astarts, counts, origins, tile_shape,
                               chunk, mode)[:2]
