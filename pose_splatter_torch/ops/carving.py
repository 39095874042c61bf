"""Shape carving: multi-camera silhouettes + RGB → colored voxel volume.

``get_volume`` is the plain averaged back-projection that preprocessing
carves with, for one frame or a batch of frames at once.

``ray_cast_visibility`` is the frontmost-occupied-voxel test on its own
(``"sort"``: one winner per pixel; ``"segment"``: a scatter-min where
ties all win), ``compute_voxel_colors`` the visibility-weighted colours
built on it, and ``shape_carve_volume`` / ``shape_carve_mask`` the
reference's whitening and binarisation of carved volumes.

Counterpart of ``pose_splatter_tpu/ops/carving.py::carve_volume``: the
nearest-pixel gathers (one fused 4-channel gather when mask and color share
intrinsics, a separate mask projection for the adaptive camera's
``K_mask``), then frontmost-voxel visibility for both carve thresholds,
visibility-weighted colors, and the two thresholds averaged into a
``[4, n1, n2, n3]`` volume.

The JAX code finds the visible voxels by sorting by (pixel, distance) with
``lax.sort(num_keys=2)``, stable in the voxel index, and scanning each
pixel's segment for its first occupied voxel. Here
:func:`ray_cast_visibility_pair` finds the same voxels with no sort and no
scan: each occupied voxel's key packs the float32 bit pattern of its
non-negative distance (which orders like the float) over its voxel index,
and the voxel wins its pixel iff its key is the pixel's least, which is
the first occupied voxel of the pixel's segment in the sort's order. On the
card one hand-written kernel (``csrc/carve_visibility.cu``) takes the
pixels' minima with 64-bit ``atomicMin``; on the CPU
:func:`visibility_pair_ref`, its plain version, takes them with
``scatter_reduce("amin")``. A minimum does not depend on the order it is
taken in, so both give the JAX sort's booleans bit for bit.

The exact carve's colours and volume for both thresholds are
:func:`carve_colors_pair`: on the card one hand-written kernel
(``csrc/carve_colors.cu``) reads each voxel's sampled colours once and
writes its [4] volume, in place of an einsum a threshold (a batched gemv
of one 1×C by C×3 product a voxel) and a dozen elementwise passes; on the
CPU :func:`carve_colors_ref`, the JAX carve's arithmetic.

With ``visibility_cap`` the visibility pair runs on a static-shape
compaction of the occupied set (:func:`compact_occupied`). Nothing there
reads a device value back to the host, so a CUDA graph can capture it, and
nothing scatters to a shared sentinel: the compaction is a search of the
occupancy's running count, and the compacted colours come back to the
voxels by a gather.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import (
    camera_positions,
    project_points,
    transform_grid,
)


def _pixel_indices(
    pix: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Round (half to even, as ``jnp.round``) and clamp [.., 2] pixel coords
    → (x, y, flat) int64 indices."""
    x = torch.clamp(torch.round(pix[..., 0]), 0, width - 1).long()
    y = torch.clamp(torch.round(pix[..., 1]), 0, height - 1).long()
    return x, y, y * width + x


def sample_nearest_pixels(images: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel gather. images [C,H,W,ch]; pix [C,N,2] → [C,N,ch]."""
    C, H, W, ch = images.shape
    _, _, flat = _pixel_indices(pix, H, W)  # [C, N]
    images_flat = images.reshape(C, H * W, ch)
    return torch.gather(images_flat, 1, flat[..., None].expand(-1, -1, ch))


def get_volume(
    images: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    grid_points: torch.Tensor,
) -> torch.Tensor:
    """Averaged nearest-pixel back-projection of ``images`` onto
    ``grid_points`` (``carving.py:63-78``), for one frame or a batch.

    One frame: images [C,H,W,ch], intrinsics [C,3,3], grid_points
    [n1,n2,n3,3] → [ch,n1,n2,n3]. A batch of B frames (the JAX callers
    ``vmap`` it): images [B,C,H,W,ch], intrinsics [C,3,3] or per frame
    [B,C,3,3], grid_points [B,n1,n2,n3,3] → [B,ch,n1,n2,n3], as one
    batched projection and gather. Extrinsics [C,4,4] are shared. The
    projection is ``project_points``' (no z clamp), in its order: the
    extrinsic product, then the intrinsic one, then ``/ (z + eps)``.
    """
    if images.dim() == 4:
        return get_volume(images[None], intrinsics, extrinsics,
                          grid_points[None])[0]
    B, C, H, W, ch = images.shape
    n1, n2, n3 = grid_points.shape[1:4]
    pts = grid_points.reshape(B, -1, 3)
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)  # [B,N,4]
    cam = torch.einsum("cij,bnj->bcni", extrinsics, pts_h)[..., :3]
    K = intrinsics.expand(B, C, 3, 3)
    pix_h = torch.einsum("bcij,bcnj->bcni", K, cam)  # [B,C,N,3]
    pix = pix_h[..., :2] / (pix_h[..., 2:3] + 1e-8)
    _, _, flat = _pixel_indices(pix, H, W)  # [B,C,N]
    sampled = torch.gather(images.reshape(B, C, H * W, ch), 2,
                           flat[..., None].expand(-1, -1, -1, ch))
    avg = sampled.mean(dim=1)  # [B,N,ch]
    return avg.transpose(1, 2).reshape(B, ch, n1, n2, n3)


def frontmost_visible(
    dists: torch.Tensor,     # [C, N] voxel-to-camera distances (>= 0)
    flat: torch.Tensor,      # [C, N] flattened pixel indices
    occupied: torch.Tensor,  # [N] bool
    n_pixels: int,
    method: str = "sort",
) -> torch.Tensor:
    """[C, N] bool: voxel n is visible from camera c iff it is occupied and
    no other occupied voxel on the same pixel is closer (the per-camera
    core of :func:`ray_cast_visibility`, ``carving.py:111-130``).

    ``"sort"``: a stable sort by (pixel, distance), the unoccupied voxels
    at +inf; the first voxel of each pixel segment wins if it is finite,
    so exactly one occupied voxel a pixel wins and ties go to the lower
    voxel index. A permutation scatter restores voxel order.
    ``"segment"``: the pixels' minimum by ``scatter_reduce("amin")``, as
    ``jax.ops.segment_min``; every co-minimal voxel wins.
    """
    masked = torch.where(occupied[None, :], dists,
                         torch.full_like(dists, math.inf))
    if method == "segment":
        idx = flat.long()
        front = torch.full((dists.shape[0], n_pixels), math.inf,
                           dtype=dists.dtype, device=dists.device)
        front.scatter_reduce_(1, idx, masked, "amin", include_self=True)
        visible = masked <= torch.gather(front, 1, idx)
    elif method == "sort":
        key = (flat.long() << 32) | masked.contiguous().view(torch.int32).long()
        _, order = torch.sort(key, dim=1, stable=True)
        p_s = torch.gather(flat, 1, order)
        first = torch.ones_like(p_s, dtype=torch.bool)
        first[:, 1:] = p_s[:, 1:] != p_s[:, :-1]
        vis_s = first & torch.isfinite(torch.gather(masked, 1, order))
        visible = torch.empty_like(vis_s).scatter_(1, order, vis_s)
    else:
        raise ValueError(f"unknown visibility method {method!r} "
                         "(expected 'sort' or 'segment')")
    return visible & occupied[None, :]


def ray_cast_visibility(
    grid_points: torch.Tensor,
    occupied: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    height: int,
    width: int,
    method: str = "sort",
) -> torch.Tensor:
    """Frontmost-voxel visibility among the occupied set
    (``carving.py:81-130``).

    grid_points [N,3]; occupied [N] bool; intrinsics [C,3,3], extrinsics
    [C,4,4] → visibility [C,N] bool. Distances to the camera centres and
    the rounded pixels of the z-clamped projection, then
    :func:`frontmost_visible` with ``method`` ``"sort"`` (one winner a
    pixel, the reference's scatter *argmin*) or ``"segment"`` (ties all
    visible).
    """
    cam_pos = camera_positions(extrinsics)  # [C, 3]
    dists = torch.linalg.norm(grid_points[None] - cam_pos[:, None, :], dim=-1)
    pix = project_points(grid_points, intrinsics, extrinsics, clamp_z=True)
    _, _, flat = _pixel_indices(pix, height, width)  # [C, N]
    return frontmost_visible(dists, flat, occupied, height * width, method)


NO_KEY = torch.iinfo(torch.int64).max  # above every packed key


def visibility_pair_ref(
    dists: torch.Tensor,  # [C, N] float32 voxel-to-camera distances (>= 0)
    flat: torch.Tensor,   # [C, N] int64 flattened pixel indices
    occ1: torch.Tensor,   # [N] bool (first threshold's occupied set)
    occ2: torch.Tensor,   # [N] bool (second threshold's occupied set)
    n_pixels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/carve_visibility.cu``: each voxel's
    key ``(float_bits(dist) << 32) | n``, each pixel's least key over an
    occupied set by ``scatter_reduce_("amin")`` into a ``[C, n_pixels]``
    table of ``NO_KEY``, and a voxel visible iff it is in the set and its
    key is its pixel's least."""
    N = dists.shape[1]
    key = (dists.view(torch.int32).long() << 32) | torch.arange(
        N, device=dists.device)
    out = []
    for occ in (occ1, occ2):
        table = torch.full((dists.shape[0], n_pixels), NO_KEY,
                           dtype=torch.int64, device=dists.device)
        table.scatter_reduce_(1, flat, torch.where(occ, key, NO_KEY), "amin",
                              include_self=True)
        out.append(occ & (torch.gather(table, 1, flat) == key))
    return out[0], out[1]


def _check_pair(dists, flat, occ1, occ2):
    """Device, dtype, shape and contiguity checks of the pair's inputs
    (nothing is read from the device); returns (C, N)."""
    if dists.dim() != 2:
        raise ValueError(f"dists has shape {tuple(dists.shape)}, expected [C, N]")
    C, N = dists.shape
    if N >= 1 << 32:
        raise ValueError(f"{N} voxels: the key's low word holds fewer than 2^32")
    if C > 65535:
        raise ValueError(f"{C} cameras: the kernel takes at most 65535")
    for name, x, dtype, shape in (("dists", dists, torch.float32, (C, N)),
                                  ("flat", flat, torch.int64, (C, N)),
                                  ("occ1", occ1, torch.bool, (N,)),
                                  ("occ2", occ2, torch.bool, (N,))):
        if x.device != dists.device:
            raise ValueError(f"{name} is on {x.device}, dists on {dists.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return C, N


def _visibility_entry():
    """``csrc/carve_visibility.cu``'s C entry, built (if needed), loaded
    and bound at first launch."""
    from pose_splatter_torch.ops import _build

    fn = _build.load("carve_visibility").carve_visibility
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 6 + [ctypes.c_longlong] * 3 + [p]
        fn.restype = ctypes.c_int
    return fn


def ray_cast_visibility_pair(
    dists: torch.Tensor,  # [C, N] float32 voxel-to-camera distances (>= 0)
    flat: torch.Tensor,   # [C, N] int64 flattened pixel indices
    occ1: torch.Tensor,   # [N] bool (first threshold's occupied set)
    occ2: torch.Tensor,   # [N] bool (second threshold's occupied set)
    n_pixels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frontmost-occupied-voxel visibility for both carve thresholds
    (``carving.py:133-173``): [C, N] bool each, voxel n visible from camera
    c iff it is in the set and is the set's first voxel on its pixel in
    (distance, voxel index) order; ties in distance go to the lower index.

    ``n_pixels`` is the image's H·W (every ``flat`` lies below it). CPU
    tensors run :func:`visibility_pair_ref`; CUDA tensors launch
    ``csrc/carve_visibility.cu`` on the current stream (a memset and two
    kernels into outputs and scratch allocated here; nothing is read back,
    so a CUDA graph can capture the call) and count it in
    ``ray_cast_visibility_pair.launches``. The two are bit-equal. The
    checks read shapes only: ``flat`` must lie in [0, ``n_pixels``), as
    ``_pixel_indices`` clamps it.
    """
    C, N = _check_pair(dists, flat, occ1, occ2)
    if dists.device.type == "cpu":
        return visibility_pair_ref(dists, flat, occ1, occ2, n_pixels)
    if dists.device.type != "cuda":
        raise ValueError(f"unsupported device {dists.device}")
    dev = dists.device
    vis = torch.empty((2, C, N), dtype=torch.bool, device=dev)
    if C * N == 0:
        return vis[0], vis[1]  # nothing to launch, nothing counted
    # Scratch keys, unsigned in the kernel; it fills them itself.
    table = torch.empty((2, C, n_pixels), dtype=torch.int64, device=dev)
    fn = _visibility_entry()
    with torch.cuda.device(dev):
        err = fn(dists.data_ptr(), flat.data_ptr(), occ1.data_ptr(),
                 occ2.data_ptr(), table.data_ptr(), vis.data_ptr(), C, N,
                 n_pixels, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"carve_visibility launch failed: CUDA error {err}")
    ray_cast_visibility_pair.launches += 1
    return vis[0], vis[1]


ray_cast_visibility_pair.launches = 0
stages.count_launches("carve_visibility", ray_cast_visibility_pair)


def compute_voxel_colors(
    grid_points: torch.Tensor,
    occupied: torch.Tensor,
    images: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    nonvisible_weight: float = 0.25,
) -> torch.Tensor:
    """Visibility-weighted voxel colours over all voxels (mask later;
    ``carving.py:176-196``): images [C,H,W,3] → [N,3], each camera's
    nearest pixel weighted 1 where the voxel is visible from it and
    ``nonvisible_weight`` elsewhere, the weights normalised."""
    C, H, W, _ = images.shape
    visible = ray_cast_visibility(grid_points, occupied, intrinsics,
                                  extrinsics, H, W)  # [C, N]
    pix = project_points(grid_points, intrinsics, extrinsics, clamp_z=True)
    sampled = sample_nearest_pixels(images, pix)  # [C, N, 3]
    weights = torch.where(visible, 1.0, nonvisible_weight)
    weights = weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)
    return torch.einsum("cn,cnk->nk", weights, sampled)


def shape_carve_volume(mask_volume: torch.Tensor, image_volume: torch.Tensor,
                       C: int = 6, eps: float = 1e-2) -> torch.Tensor:
    """Whiten image voxels outside the carved mask
    (``shape_carving.py:90-95``)."""
    mult = torch.broadcast_to(mask_volume > (C - 1.0) / C - eps,
                              image_volume.shape)
    return torch.where(mult, torch.ones_like(image_volume), image_volume)


def shape_carve_mask(volume: torch.Tensor, C: int = 6,
                     eps: float = 1e-2) -> torch.Tensor:
    """Binarize the first three channels at the reference's three carve
    thresholds (``shape_carving.py:98-110``); the thresholds are float32,
    as the JAX package's."""
    th = torch.tensor([(C - 1.0) / C - eps, 1.0 - eps, (C - 2.0) / C - eps],
                      dtype=torch.float32, device=volume.device)
    binarized = (volume[:3] > th[:, None, None, None]).to(volume.dtype)
    return torch.cat([binarized, volume[3:]], dim=0)


def compact_occupied(occ: torch.Tensor, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape compaction of an occupancy mask (``carving.py:215-229``).

    Returns ``(comp [cap] int64, overflow [])``: ``comp[m]`` is the voxel id
    of the m-th occupied voxel (the first ``cap`` in voxel order; ``N``
    marks empty slots), ``overflow`` counts occupied voxels past the cap.

    The JAX function scatters each voxel id to its exclusive prefix count,
    every dropped voxel to one shared slot. Here ``comp[m]`` is found
    instead as the first voxel whose inclusive count reaches m + 1 (a
    ``searchsorted`` of the non-decreasing running count; past the last
    occupied voxel it returns N): the same ids, with no duplicate writes
    and no read-back.
    """
    N = occ.shape[0]
    count = torch.cumsum(occ.long(), 0)  # inclusive running count
    want = torch.arange(1, cap + 1, device=occ.device)
    comp = torch.searchsorted(count, want)
    return comp, torch.clamp(count[-1] - cap, min=0)


def _weights_of(visible: torch.Tensor, nonvisible_weight: float) -> torch.Tensor:
    """[C, N] weights: 1 where visible, ``nonvisible_weight`` elsewhere,
    over their sum across the cameras (at least 1e-8)."""
    weights = torch.where(visible, 1.0, nonvisible_weight)
    return weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)


def _volume(occupied: torch.Tensor, colors: torch.Tensor,
            volume_fill_color: float) -> torch.Tensor:
    """[4, N]: the occupancy as float, then the [N, 3] colours where
    occupied and ``volume_fill_color`` elsewhere."""
    vol_rgb = torch.where(occupied[:, None], colors,
                          torch.full_like(colors, volume_fill_color))
    return torch.cat([occupied.float()[None, :], vol_rgb.T], dim=0)


def carve_colors_ref(
    sampled: torch.Tensor,  # [C, N, 3] float32 nearest-pixel colours
    vis1: torch.Tensor,     # [C, N] bool (first threshold's visibility)
    vis2: torch.Tensor,     # [C, N] bool (second threshold's visibility)
    occ1: torch.Tensor,     # [N] bool (first threshold's occupied set)
    occ2: torch.Tensor,     # [N] bool (second threshold's occupied set)
    nonvisible_weight: float,
    volume_fill_color: float,
) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/carve_colors.cu``: each threshold's
    visibility-weighted colours (an einsum over the cameras) and volume,
    the two volumes averaged into [4, N] (``carving.py:317-326``)."""
    out = torch.zeros((4, sampled.shape[1]), dtype=torch.float32,
                      device=sampled.device)
    for occupied, visible in ((occ1, vis1), (occ2, vis2)):
        colors = torch.einsum("cn,cnk->nk",
                              _weights_of(visible, nonvisible_weight), sampled)
        out = out + _volume(occupied, colors, volume_fill_color) / 2.0
    return out


MAX_COLOR_CAMERAS = 64  # the kernel keeps a voxel's visibility in 64 bits


def _check_colors(sampled, vis1, vis2, occ1, occ2):
    """Device, dtype, shape and stride checks of the colour stage's inputs
    (nothing is read from the device); returns (C, N)."""
    if sampled.dim() != 3 or sampled.shape[2] != 3:
        raise ValueError(f"sampled has shape {tuple(sampled.shape)}, "
                         "expected [C, N, 3]")
    C, N, _ = sampled.shape
    if sampled.dtype != torch.float32:
        raise TypeError(f"sampled has dtype {sampled.dtype}, expected "
                        "torch.float32")
    if sampled.stride(2) != 1:
        raise ValueError("sampled's colour channels must be adjacent "
                         f"(strides {sampled.stride()})")
    if C > MAX_COLOR_CAMERAS:
        raise ValueError(f"{C} cameras: the kernel takes at most "
                         f"{MAX_COLOR_CAMERAS}")
    for name, x, shape in (("vis1", vis1, (C, N)), ("vis2", vis2, (C, N)),
                           ("occ1", occ1, (N,)), ("occ2", occ2, (N,))):
        if x.device != sampled.device:
            raise ValueError(f"{name} is on {x.device}, sampled on "
                             f"{sampled.device}")
        if x.dtype != torch.bool:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.bool")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sampled.requires_grad:
        raise ValueError("sampled requires grad: the carve is forward only")
    return C, N


def _colors_entry():
    """``csrc/carve_colors.cu``'s C entry, built (if needed), loaded and
    bound at first launch."""
    from pose_splatter_torch.ops import _build

    fn = _build.load("carve_colors").carve_colors
    if fn.argtypes is None:
        p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, i64, i64, p, p, p, p, f32, f32, p, i64, i64, p]
        fn.restype = ctypes.c_int
    return fn


def carve_colors_pair(
    sampled: torch.Tensor,  # [C, N, 3] float32, channels adjacent
    vis1: torch.Tensor,     # [C, N] bool (first threshold's visibility)
    vis2: torch.Tensor,     # [C, N] bool (second threshold's visibility)
    occ1: torch.Tensor,     # [N] bool (first threshold's occupied set)
    occ2: torch.Tensor,     # [N] bool (second threshold's occupied set)
    nonvisible_weight: float,
    volume_fill_color: float,
) -> torch.Tensor:
    """The exact carve's volume [4, N] from its sampled colours and both
    thresholds' visibility and occupancy: for each threshold the colours
    weighted 1 where visible and ``nonvisible_weight`` elsewhere over the
    weights' sum, channel 0 the occupancy and channels 1–3 the colours
    where occupied and ``volume_fill_color`` elsewhere; the two volumes
    averaged.

    ``sampled`` may be the stride-4 view of the fused [C, N, 4] gather (the
    kernel then reads each colour as one 16-byte load) or any tensor whose
    channels are adjacent. CPU tensors run :func:`carve_colors_ref`; CUDA
    tensors launch ``csrc/carve_colors.cu`` on the current stream (one
    kernel into an output allocated here; nothing is read back, so a CUDA
    graph can capture the call) and count it in
    ``carve_colors_pair.launches``. On the card the kernel sums over the
    cameras in the order of the batched gemv that the plain version's
    einsum runs there, so the two give the same volume bit for bit (but
    in cuBLAS's short last chunk of voxels, within an ulp or two). The
    carve is forward only: an input that requires grad is refused.
    """
    C, N = _check_colors(sampled, vis1, vis2, occ1, occ2)
    if sampled.device.type == "cpu":
        return carve_colors_ref(sampled, vis1, vis2, occ1, occ2,
                                nonvisible_weight, volume_fill_color)
    if sampled.device.type != "cuda":
        raise ValueError(f"unsupported device {sampled.device}")
    dev = sampled.device
    out = torch.empty((4, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out  # nothing to launch, nothing counted
    fn = _colors_entry()
    with torch.cuda.device(dev):
        err = fn(sampled.data_ptr(), sampled.stride(0), sampled.stride(1),
                 vis1.data_ptr(), vis2.data_ptr(), occ1.data_ptr(),
                 occ2.data_ptr(), nonvisible_weight, volume_fill_color,
                 out.data_ptr(), C, N,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"carve_colors launch failed: CUDA error {err}")
    carve_colors_pair.launches += 1
    return out


carve_colors_pair.launches = 0
stages.count_launches("carve_colors", carve_colors_pair)


def carve_volume(
    mask: torch.Tensor,
    rgb: torch.Tensor,
    center: torch.Tensor,
    angle,
    grid: torch.Tensor,
    K_mask: Optional[torch.Tensor],
    K_color: torch.Tensor,
    extrinsics: torch.Tensor,
    volume_fill_color: float = 0.45,
    nonvisible_weight: float = 0.25,
    visibility_cap: Optional[int] = None,
    return_overflow: bool = False,
):
    """Full shape-carving forward (``carving.py:232-373``).

    Args:
        mask:   [C, H, W] silhouettes in {0, 1} (float).
        rgb:    [C, H, W, 3] images in [0, 1].
        center: [3] world-space shift for this frame.
        angle:  scalar yaw for this frame.
        grid:   [n1, n2, n3, 3] canonical voxel grid.
        K_mask: [C, 3, 3] intrinsics of the mask back-projection (the
                adaptive camera's per-frame ``temp_K``), or ``None`` to share
                ``K_color`` (one fused mask + RGB gather).
        K_color:[C, 3, 3] intrinsics of colors and visibility (always the
                cameras' own).
        extrinsics: [C, 4, 4].
        visibility_cap: if set (and below N), the visibility pair runs
                on the first ``visibility_cap`` occupied voxels of the
                second threshold's set (which holds the first's). Exact when
                they fit; occupied voxels past the cap get the
                all-``nonvisible_weight`` average, as if fully occluded, and
                are counted in the overflow. ``None`` is the exact path.
        return_overflow: also return that count [] (int64).

    Returns:
        volume [4, n1, n2, n3]: ch0 occupancy, ch1:4 RGB (empty voxels get
        ``volume_fill_color``), averaged over the two carve thresholds
        (+ the overflow if requested).
    """
    C = mask.shape[0]
    n1, n2, n3 = grid.shape[:3]
    N = n1 * n2 * n3

    pts = transform_grid(grid, center, angle).reshape(-1, 3)
    imgH, imgW = rgb.shape[1], rgb.shape[2]
    pix = project_points(pts, K_color, extrinsics, clamp_z=True)  # [C,N,2]
    if K_mask is None:
        fused = torch.cat([rgb, mask[..., None]], dim=-1)  # [C,H,W,4]
        samp = sample_nearest_pixels(fused, pix)  # [C,N,4]
        sampled = samp[..., :3]
        mask_flat = samp[..., 3].mean(dim=0)  # [N]
    else:
        # The mask's own projection, without the z clamp (carving.py:302).
        sampled = sample_nearest_pixels(rgb, pix)  # [C,N,3]
        pix_m = project_points(pts, K_mask, extrinsics)
        mask_flat = sample_nearest_pixels(
            mask[..., None], pix_m)[..., 0].mean(dim=0)

    cam_pos = camera_positions(extrinsics)  # [C,3]
    occ1 = mask_flat >= 1.0
    occ2 = mask_flat >= (C - 1.0) / C
    overflow = torch.zeros((), dtype=torch.long, device=mask.device)

    if visibility_cap is None or visibility_cap >= N:
        dists = torch.linalg.norm(pts[None] - cam_pos[:, None, :], dim=-1)
        _, _, flat = _pixel_indices(pix, imgH, imgW)
        vis1, vis2 = ray_cast_visibility_pair(dists, flat, occ1, occ2,
                                              imgH * imgW)
        out = carve_colors_pair(sampled, vis1, vis2, occ1, occ2,
                                nonvisible_weight, volume_fill_color)
    else:
        out = torch.zeros((4, N), dtype=torch.float32, device=mask.device)
        M = visibility_cap
        comp, overflow = compact_occupied(occ2, M)
        valid_c = comp < N
        # One row gather pulls the compacted voxels' positions and occ1
        # flags together; empty slots read an all-zero pad row.
        aux = torch.cat([pts, occ1[:, None].float()], dim=1)  # [N,4]
        aux = torch.cat([aux, aux.new_zeros((1, 4))], dim=0)
        aux_c = aux.index_select(0, comp)  # [M,4]
        pts_c = aux_c[:, :3]
        occ1_c = (aux_c[:, 3] > 0.5) & valid_c

        pix_c = project_points(pts_c, K_color, extrinsics, clamp_z=True)
        dists_c = torch.linalg.norm(pts_c[None] - cam_pos[:, None, :], dim=-1)
        _, _, flat_c = _pixel_indices(pix_c, imgH, imgW)
        vis1_c, vis2_c = ray_cast_visibility_pair(dists_c, flat_c, occ1_c,
                                                  valid_c, imgH * imgW)
        samp_pad = torch.cat([sampled, sampled.new_zeros((C, 1, 3))], dim=1)
        sampled_c = samp_pad.index_select(1, comp)  # [C,M,3]

        # Each voxel's slot in the compaction (M: not in it). Overflowed
        # occupied voxels, and only those, keep the uniform average, as if
        # fully occluded (carving.py:353).
        slot = torch.cumsum(occ2.long(), 0) - 1
        slot = torch.where(occ2 & (slot < M), slot, M)
        in_cap = (slot < M)[:, None]
        slot = slot.clamp(max=M - 1)
        base_colors = sampled.mean(dim=0)
        for occupied, visible_c in ((occ1, vis1_c), (occ2, vis2_c)):
            colors_c = torch.einsum(
                "cm,cmk->mk", _weights_of(visible_c, nonvisible_weight),
                sampled_c)  # [M,3]
            colors = torch.where(in_cap, colors_c.index_select(0, slot),
                                 base_colors)
            out = out + _volume(occupied, colors, volume_fill_color) / 2.0
    vol = out.reshape(4, n1, n2, n3)
    if return_overflow:
        return vol, overflow
    return vol
