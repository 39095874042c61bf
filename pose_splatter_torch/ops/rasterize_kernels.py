"""Instance binning and the forward compositor (counterpart of
``pose_splatter_tpu/ops/rasterize_pallas.py``).

Host side (plain PyTorch): each Gaussian is duplicated once per pixel tile
its binning circle touches, and the copies are laid out in one flat array,
grouped by tile in compositing order, each tile's segment padded to a
multiple of G rows (``_build_instances``, ``gather_instances``). Two finite
capacities are truncated and COUNTED, never silent: Gaussians spanning more
than ``expand`` tiles, and segment rows past the array's ``mcap`` rows.

Device side: :func:`composite_instances` walks each tile's segment. On a
CUDA tensor it launches the hand-written kernel ``csrc/composite_fwd.cu``;
on a CPU tensor it runs :func:`composite_instances_ref`, the plain PyTorch
version of the same chunk walk. There is no fallback between the two.

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
        overflow [B] int64: instances dropped by either cap.

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

    counts_all = torch.bincount(flat, minlength=B * T + 1)  # + dead slots
    counts = counts_all[:B * T].reshape(B, T)
    nsteps = (counts + G - 1) // G
    astarts = G * torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=dev),
         torch.cumsum(nsteps, dim=1)], dim=1)  # [B, T+1]

    sorted_tiles, perm = torch.sort(flat, stable=True)
    group_start = torch.cumsum(counts_all, 0) - counts_all
    rank_sorted = (torch.arange(flat.numel(), device=dev)
                   - group_start[sorted_tiles])
    rank = torch.empty_like(rank_sorted)
    rank[perm] = rank_sorted  # perm is a permutation: unique indices
    rank = rank.reshape(B, N, expand)

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
            overflow_span + overflow_cap)


def gather_instances(packed: torch.Tensor, dest: torch.Tensor,
                     src: torch.Tensor, mcap: int) -> torch.Tensor:
    """[B,N,F] packed Gaussians → [B,mcap,F] instance arrays (padding rows
    all-zero). Slot k goes to row ``dest[k]`` from Gaussian ``src[k]``;
    rows >= mcap are dropped.

    The slot map is inverted with one scatter whose indices are unique and
    in range: each dropped slot k writes its own dump column ``mcap + k``,
    which is cut off afterwards. Then the rows are gathered.
    """
    B, N, nf = packed.shape
    M = dest.shape[1]
    dev = packed.device
    keep = dest < mcap
    idx = torch.where(keep, dest, mcap + torch.arange(M, device=dev))
    inv = torch.full((B, mcap + M), N, dtype=torch.long, device=dev)
    inv.scatter_(1, idx, src)
    inv = inv[:, :mcap]
    padded = torch.cat(
        [packed, torch.zeros((B, 1, nf), dtype=packed.dtype, device=dev)], 1)
    return torch.gather(padded, 1, inv[..., None].expand(-1, -1, nf))


# ----------------------------------------------------------------------------
# The compositor: plain version and kernel wrapper.
# ----------------------------------------------------------------------------

def _chunk_alpha(mode: str, f: torch.Tensor, xs: torch.Tensor,
                 ys: torch.Tensor, rowmask: torch.Tensor) -> torch.Tensor:
    """Alpha [A,G,P] for chunks f [A,G,16] at pixels xs, ys [A,1,P]."""
    dx = xs - f[..., 0:1]
    dy = ys - f[..., 1:2]
    opacity = f[..., 6:7]
    if mode == "conic":
        A, B, C = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
        raw = opacity * torch.exp(-sigma)
        a = torch.clamp(raw, max=ALPHA_CLAMP)
        live = (sigma >= 0) & (raw >= ALPHA_SKIP) & rowmask
        return torch.where(live, a, torch.zeros_like(a))
    c, s = f[..., 2:3], f[..., 3:4]
    sx, sy = f[..., 4:5], f[..., 5:6]
    u = c * dx + s * dy
    v = -s * dx + c * dy
    sx2 = 2.0 * sx * sx + 1e-8
    sy2 = 2.0 * sy * sy + 1e-8
    a = opacity * torch.exp(-(u * u / sx2 + v * v / sy2))
    return torch.where(rowmask, a, torch.zeros_like(a))


def composite_instances_ref(inst, astarts, counts, origins,
                            tile_shape: Tuple[int, int], chunk: int,
                            mode: str):
    """Plain PyTorch version of the forward compositor.

    inst [R,16] f32; astarts, counts [T] int; origins [T,2] int (y0, x0).
    Walks every tile's segment in chunks of ``chunk`` rows, all live tiles
    at once: T = T_in · exclusive cumprod(1 − a) within the chunk and, in
    conic mode, the gate T·(1 − a) ≥ 1e-4 and the stop once no pixel of a
    tile has T ≥ 1e-4. Returns rgb [T,3,P], alpha [T,P], jstop [T] int32.
    """
    early_stop = mode == "conic"
    pixel_offset = PIXEL_OFFSET[mode]
    th, tw = tile_shape
    P = th * tw
    G = chunk
    nt = astarts.shape[0]
    dev = inst.device
    astarts = astarts.long()
    counts = counts.long()
    pidx = torch.arange(P, device=dev)
    xs = (origins[:, 1:2].float() + (pidx % tw).float()) + pixel_offset
    ys = (origins[:, 0:1].float() + (pidx // tw).float()) + pixel_offset
    t_in = torch.ones((nt, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((nt, 4, P), dtype=torch.float32, device=dev)
    jstop = torch.zeros((nt,), dtype=torch.int32, device=dev)
    n_steps = (counts + G - 1) // G
    live = n_steps > 0
    rows_g = torch.arange(G, device=dev)
    for j in range(int(n_steps.max()) if nt else 0):
        act = torch.nonzero(live & (n_steps > j)).reshape(-1)
        if act.numel() == 0:
            break
        rowmask = rows_g[None, :] < (counts[act] - j * G)[:, None]  # [A,G]
        rows = astarts[act, None] + j * G + rows_g[None, :]
        f = inst[torch.where(rowmask, rows, torch.zeros_like(rows))]  # [A,G,16]
        a = _chunk_alpha(mode, f, xs[act, None, :], ys[act, None, :],
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
    return acc[:, :3], acc[:, 3], jstop


def _kernel_lib():
    from pose_splatter_torch.ops import _build

    lib = _build.load("composite_fwd")
    fn = lib.composite_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       p]
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


def composite_instances(inst, astarts, counts, origins,
                        tile_shape: Tuple[int, int], chunk: int, mode: str):
    """Composite per-tile instance segments in ``"ellipse"`` (2D) or
    ``"conic"`` (3D) mode.

    inst [R,16] float32 (R a multiple of ``chunk``); astarts, counts [T]
    int32; origins [T,2] int32 (y0, x0). Returns rgb [T,3,P], alpha [T,P],
    jstop [T] int32 (chunks walked per tile).

    CPU tensors run :func:`composite_instances_ref`; CUDA tensors launch
    ``csrc/composite_fwd.cu`` (built at first use) and count the launch in
    ``composite_instances.launches``.
    """
    if mode not in ("conic", "ellipse"):
        raise ValueError(f"unknown mode {mode!r}")
    if inst.device.type == "cpu":
        return composite_instances_ref(inst, astarts, counts, origins,
                                       tile_shape, chunk, mode)
    if inst.device.type != "cuda":
        raise ValueError(f"unsupported device {inst.device}")
    th, tw = tile_shape
    P = th * tw
    nt = astarts.shape[0]
    R = inst.shape[0]
    dev = inst.device
    _check("inst", inst, torch.float32, (R, F), dev)
    _check("astarts", astarts, torch.int32, (nt,), dev)
    _check("counts", counts, torch.int32, (nt,), dev)
    _check("origins", origins, torch.int32, (nt, 2), dev)
    if R % chunk:
        raise ValueError(f"instance rows {R} not a multiple of chunk {chunk}")
    if P > 1024 or not 0 < chunk <= 768:
        raise ValueError(f"tile {tile_shape} / chunk {chunk} not supported "
                         "(P <= 1024 pixels, chunk <= 768 rows)")
    if inst.data_ptr() % 16:
        raise ValueError("inst must be 16-byte aligned")
    rgb = torch.empty((nt, 3, P), dtype=torch.float32, device=dev)
    alpha = torch.empty((nt, P), dtype=torch.float32, device=dev)
    jstop = torch.empty((nt,), dtype=torch.int32, device=dev)
    if nt == 0:
        return rgb, alpha, jstop  # nothing to launch, nothing counted
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(inst.data_ptr(), R, astarts.data_ptr(), counts.data_ptr(),
                 origins.data_ptr(), rgb.data_ptr(), alpha.data_ptr(),
                 jstop.data_ptr(), nt, th, tw, chunk, int(mode == "conic"),
                 stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_instances.launches += 1
    return rgb, alpha, jstop


composite_instances.launches = 0
