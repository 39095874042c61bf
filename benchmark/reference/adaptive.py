"""Plain PyTorch adaptive camera of the reference: the host hook, the carve
through the frame's intrinsics, the forward and the train steps.

With ``adaptive_camera`` each frame brings its own intrinsics ``temp_K``
for the observed views and a carve seed, both computed from its masks:

- the hook (``hook``): each view's mask medoid, the mask pixel nearest the
  mask's centroid (the first in row-major order on a tie); the seed, the
  point of the joint DLT over every view (rows u·P3 − P1 and v·P3 − P2,
  its null vector by SVD in float64); and each view's principal point
  moved so that the seed projects onto its medoid. P = K·[R|t] is taken in
  float32 as a chain of fused multiply-adds over the inner index (emulated
  in float64 with one rounding a step), as NumPy's float32 matrix product
  computes it on x86-64, and ``temp_K`` is rounded to float32: the
  float32 rig's own hook, so that both sides carve through the same
  ``temp_K``;
- the carve (``carve``): the grid yaw-rotated and moved to the seed; each
  voxel's mask sampled through ``temp_K`` (the projection divides by
  z + 1e-8, no clamp), its colours and visibility through the rig's K;
  then ``model.carve``'s two thresholds and weights;
- the forward (``forward``): ``model.py``'s U-Nets, selection and head;
  the 3D Gaussians posed at the frame's ``p_3d`` (not the seed) and the
  target view rendered through its ``temp_K`` (every view is observed in
  the configurations that use this).

``instance_cap`` (rows a camera of the binning) raises ``render_rows``'
4n + T·G by Gaussians appended past the last, invalid and so in no tile,
as ``features.py`` does. ``train_steps`` is ``train.py``'s with this
forward (Adam as written there).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference.model import (
    CHUNK,
    TILE,
    Cameras,
    Params,
    Spec,
    _frontmost,
    _nearest,
    _pack,
    _pixel_flat,
    camera_positions,
    gaussians,
    is_buffer,
    pose_3d,
    process_volume,
    project_gaussians,
    project_points,
    render_rows,
    yaw_rotation,
)
from benchmark.reference.train import loss


# ---------------------------------------------------------------------------
# The host hook.
# ---------------------------------------------------------------------------

def medoids(masks) -> torch.Tensor:
    """[V,H,W] masks -> [V,2] float64 (u, v): each view's mask pixel nearest
    its centroid, the first in row-major order on a tie."""
    out = []
    for i, m in enumerate(masks.cpu()):
        ys, xs = torch.nonzero(m, as_tuple=True)
        n = xs.numel()
        if n == 0:
            raise ValueError(f"mask {i} is empty")
        # Integer sums are exact; one rounding in the division.
        my, mx = ys.sum().double() / n, xs.sum().double() / n
        d2 = (ys.double() - my) ** 2 + (xs.double() - mx) ** 2
        j = int(torch.argmin(d2))
        out.append([float(xs[j]), float(ys[j])])
    return torch.tensor(out, dtype=torch.float64)


def _projections(Ks, Es) -> torch.Tensor:
    """K·[R|t] [V,3,4] in float32 as a fused multiply-add chain over the
    inner index (one rounding a step), returned in float64."""
    K, E = Ks.double(), Es[:, :3, :].double()
    acc = (K[:, :, 0:1] * E[:, None, 0, :]).float().double()
    for j in (1, 2):
        acc = (acc + K[:, :, j:j + 1] * E[:, None, j, :]).float().double()
    return acc


def hook(masks, Ks, Es) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adaptive camera's intrinsics and seed of one frame from its
    masks [V,H,W] and the observed views' rig Ks [V,3,3], Es [V,4,4]
    (float32): temp_K [V,3,3] float32 and seed [3] float64, on the CPU."""
    Ks, Es = Ks.detach().cpu(), Es.detach().cpu()
    med = medoids(masks)
    P = _projections(Ks, Es)
    A = torch.cat([med[:, 0:1] * P[:, 2] - P[:, 0],
                   med[:, 1:2] * P[:, 2] - P[:, 1]], dim=0)  # [2V, 4]
    X_h = torch.linalg.svd(A).Vh[-1]
    X = X_h[:3] / X_h[3]
    X_cam = torch.einsum("vij,j->vi", Es[:, :3, :3].double(), X) + Es[:, :3, 3].double()
    uv = X_cam[:, :2] / X_cam[:, 2:3]
    f = torch.stack([Ks[:, 0, 0], Ks[:, 1, 1]], dim=1).double()
    temp_K = Ks.clone()
    temp_K[:, 0:2, 2] = (med - f * uv).to(Ks.dtype)
    return temp_K, X


# ---------------------------------------------------------------------------
# The carve and the forward.
# ---------------------------------------------------------------------------

def carve(spec: Spec, grid, mask, img, seed, angle, temp_K, Ks, Es):
    """``model.carve`` with the grid at ``seed`` and the masks sampled
    through ``temp_K`` [C',3,3] (no z clamp): [4, n1, n2, n3]."""
    C = mask.shape[0]
    n1, n2, n3 = grid.shape[:3]
    rot = yaw_rotation(angle)
    pts = (torch.einsum("abci,ji->abcj", grid, rot)
           + seed.reshape(1, 1, 1, 3)).reshape(-1, 3)
    H, W = img.shape[1], img.shape[2]
    flat = _pixel_flat(project_points(pts, Ks, Es, clamp_z=True), H, W)
    sampled = _nearest(img, flat)
    flat_m = _pixel_flat(project_points(pts, temp_K, Es), H, W)
    mask_flat = _nearest(mask[..., None], flat_m)[..., 0].mean(dim=0)
    dists = torch.linalg.norm(pts[None] - camera_positions(Es)[:, None, :], dim=-1)
    out = torch.zeros((4, pts.shape[0]), dtype=torch.float32, device=pts.device)
    for occupied in (mask_flat >= 1.0, mask_flat >= (C - 1.0) / C):
        visible = _frontmost(dists, flat, occupied)
        weights = torch.where(visible, 1.0, 0.25)
        weights = weights / torch.clamp(weights.sum(dim=0, keepdim=True), min=1e-8)
        colors = torch.einsum("cn,cnk->nk", weights, sampled)
        vol_rgb = torch.where(occupied[:, None], colors,
                              torch.full_like(colors, spec.fill))
        out = out + torch.cat([occupied.float()[None, :], vol_rgb.T], dim=0) / 2.0
    return out.reshape(4, n1, n2, n3)


def render_3d(g, E, K, spec: Spec, instance_cap: Optional[int]):
    """Posed 3D Gaussians ``g`` to one camera E [1,4,4], K [1,3,3]: rgb
    [H,W,3] on the background, alpha [H,W] and the dropped-row count."""
    n = g["means"].shape[0]
    mean2d, conic, depth, radius, ok = project_gaussians(
        g["means"], g["quats"], torch.exp(g["log_scales"]), E, K, spec.W, spec.H)
    ok = ok & g["valid"][None, :]
    keys = torch.where(ok, depth, torch.full_like(depth, math.inf))
    order = torch.sort(keys, dim=1, stable=True).indices[0]
    opac = torch.sigmoid(g["logit_opacities"])
    packed = _pack([mean2d[0], conic[0], torch.zeros_like(opac[:, None]),
                    opac[:, None], g["colors"], radius[0][:, None]], 11)
    packed = packed.index_select(0, order)[None]
    ok = ok[0][order][None]
    T = -(-spec.H // TILE[0]) * -(-spec.W // TILE[1])
    cap = instance_cap if instance_cap is not None else 4 * n + T * CHUNK
    pad = (cap - T * CHUNK) // 4 - n
    if pad < 0 or 4 * (n + pad) + T * CHUNK != cap:
        raise ValueError(f"instance_cap {cap}: not 4n' + T*G for any n' >= {n}")
    packed = torch.cat([packed, packed.new_zeros((1, pad, packed.shape[-1]))], 1)
    ok = torch.cat([ok, ok.new_zeros((1, pad))], 1)
    rgb, alpha, dropped = render_rows(packed, packed[..., 0:2], packed[..., 10],
                                      ok, "conic", spec.H, spec.W, spec.tile_expand)
    bg = torch.tensor(spec.background, dtype=torch.float32, device=rgb.device)
    rgb = rgb + (1.0 - alpha[..., None]) * bg.reshape(1, 1, 1, 3)
    return rgb[0], alpha[0], dropped


def forward(P: Params, spec: Spec, cams: Cameras, grid, mask, img, p_3d, angle,
            view: int, train: bool, instance_cap: Optional[int] = None):
    """One frame of the adaptive 3D model rendered to observed view
    ``view``: rgb [H,W,3], alpha [H,W], the dropped-row count, and the
    hook's temp_K and seed (on the CPU)."""
    if spec.mode != "3d" or spec.holdout:
        raise ValueError("the adaptive reference renders 3D Gaussians to "
                         "observed views, with no holdout")
    temp_K, seed = hook(mask, cams.Ks_obs, cams.Es_obs)
    K_dev = temp_K.to(img.device)
    volume = carve(spec, grid, mask, img, seed.float().to(img.device), angle,
                   K_dev, cams.Ks_obs, cams.Es_obs)
    vol_flat = process_volume(P, volume, spec, train)
    g = pose_3d(gaussians(P, vol_flat, grid.reshape(-1, 3), spec), angle, p_3d)
    o = spec.observed.index(view)
    rgb, alpha, dropped = render_3d(g, cams.Es[view:view + 1],
                                    K_dev[o:o + 1], spec, instance_cap)
    return rgb, alpha, dropped, temp_K, seed


def train_steps(weights: Params, spec: Spec, cams: Cameras, grid,
                steps: Sequence[Dict], lr: float,
                instance_cap: Optional[int] = None) -> Dict:
    """``train.train_steps`` through the adaptive forward: each step's
    loss, each leaf's first gradient norm (None where the loss does not
    reach it), each leaf's change after the last step, and each step's
    temp_K and seed."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    leaves = [k for k in P if not is_buffer(k)]
    m = {k: torch.zeros_like(P[k]) for k in leaves}
    v = {k: torch.zeros_like(P[k]) for k in leaves}
    losses: List[float] = []
    first: Dict[str, Optional[float]] = {}
    hooks = []
    for t, s in enumerate(steps, start=1):
        for k in leaves:
            P[k].requires_grad_(True)
        rgb, alpha, _, temp_K, seed = forward(
            P, spec, cams, grid, s["mask"], s["img"], s["p_3d"], s["angle"],
            s["view"], True, instance_cap)
        hooks.append((temp_K, seed))
        obs = s["obs"]
        value = loss(rgb, alpha, s["img"][obs], s["mask"][obs], spec)
        grads = torch.autograd.grad(value, [P[k] for k in leaves],
                                    allow_unused=True)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                P[k] = P[k].detach()
                if t == 1:
                    first[k] = None if g is None else float(g.norm())
                if g is None:
                    continue
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mhat = m[k] / (1.0 - 0.9 ** t)
                vhat = v[k] / (1.0 - 0.999 ** t)
                P[k] = P[k] - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        del grads, rgb, alpha, value
    change = {k: float((P[k] - weights[k]).norm()) for k in leaves}
    return dict(losses=losses, grad_norms=first, change_norms=change, hooks=hooks)

