"""Plain PyTorch forward of the Pose Splatter model, over a flat parameter
dict.

Parameters are a dict name -> tensor under the names the program's
``state_dict`` uses, so one dict made by the benchmark serves both sides.
The forward is written as functions, in float32, in the order of
operations that the model's description fixes:

    carve (nearest-pixel gathers, frontmost-voxel visibility for both
    thresholds, visibility-weighted colours) -> residual 3D U-Nets (BN with
    batch statistics in training, running statistics in eval) -> adaptive
    threshold and top-``max_n`` selection -> per-voxel MLP head ->
    2D: view-anchored ellipses; 3D: posed world Gaussians, EWA projection
    and depth sort -> binning into (8, 128) tiles, each Gaussian in at most
    ``tile_expand`` tiles and at most 4N + T·G rows a camera -> front-to-back
    compositing of each tile's rows -> background by transmittance.

The compositor walks each tile's rows in chunks of 64 as one function of
its inputs (no in-place state), so autograd gives its gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = (8, 128)
CHUNK = 64
ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
STOP_T = 1e-4
PIXEL_OFFSET = {"ellipse": 0.0, "conic": 0.5}
FEATS = 16

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# The model's description: sizes and parameter names.
# ---------------------------------------------------------------------------

class Spec:
    """The sizes of one configuration (its JSON file as a dict)."""

    def __init__(self, cfg: dict):
        self.mode = cfg["gaussian_mode"]
        ds = cfg["image_downsample"]
        self.W = cfg["image_width"] // ds
        self.H = cfg["image_height"] // ds
        self.ell = float(cfg["ell"])
        self.grid_size = int(cfg["grid_size"])
        self.volume_idx = [list(map(int, r)) for r in cfg["volume_idx"]]
        self.fill = float(cfg["volume_fill_color"])
        self.holdout = list(cfg["holdout_views"])
        self.cameras = int(cfg["cameras"])
        self.observed = [i for i in range(self.cameras) if i not in self.holdout]
        self.min_n = int(cfg.get("min_n", 1024))
        self.max_n = int(cfg.get("max_n", 16000))
        self.num_unets = int(cfg.get("num_unets", 3))
        self.bf = int(cfg.get("base_filters", 8))
        self.in_ch, self.out_ch, self.z_dim = 4, 8, 512
        gc = cfg.get("gaussian_config", {})
        self.sigma_cutoff = float(gc.get("sigma_cutoff", 3.0))
        self.tile_expand = int(gc.get("tile_expand") or 16)
        self.anchored = bool(gc.get("view_anchored", False)) and self.mode == "2d"
        self.n_params = 14 if self.mode == "3d" else 9
        self.img_lambda = float(cfg["img_lambda"])
        self.ssim_lambda = float(cfg["ssim_lambda"])
        self.lr = float(cfg["lr"])
        self.crop = tuple(b - a for a, b in self.volume_idx)
        self.ns = tuple(s // 16 for s in self.crop)
        self.voxel_size = self.ell / self.grid_size
        self.pt, self.mt, self.delta = 0.25, 0.25, 0.05
        self.color_clip = (0.0, 0.99)
        self.background = (1.0, 1.0, 1.0)


def _unet_layers(cin: int, cout: int, bf: int, ns, z: int):
    """(module name, kind, weight shape) of one U-Net, in registration
    order. Kinds: conv, tconv, dense, bn."""
    out = []

    def block(name, i, f):
        out.extend([(f"{name}.conv0", "conv", (f, i, 3, 3, 3)),
                    (f"{name}.bn0", "bn", (f,)),
                    (f"{name}.conv1", "conv", (f, f, 3, 3, 3)),
                    (f"{name}.bn1", "bn", (f,))])

    nprod = ns[0] * ns[1] * ns[2]
    widths = [cin, bf, 2 * bf, 4 * bf, 8 * bf, 16 * bf]
    for k in range(5):
        block(f"encoder{k + 1}", widths[k], widths[k + 1])
    out.extend([("mlp_1a", "dense", (512, 16 * bf * nprod)),
                ("mlp_1b", "dense", (z, 512)),
                ("mlp_2", "dense", (16 * bf * nprod, z))])
    for k in (4, 3, 2, 1):
        f = widths[k]
        out.append((f"upconv{k}", "tconv", (2 * f, f, 2, 2, 2)))
        block(f"decoder{k}", 2 * f, f)
    out.append(("final_conv", "conv", (cout, bf, 1, 1, 1)))
    return out


def layers(spec: Spec) -> List[Tuple[str, str, tuple]]:
    """Every layer of the net: (name, kind, weight shape), registration
    order, under the program's module names."""
    out = []
    args = (spec.bf, spec.ns, spec.z_dim)
    for u in range(spec.num_unets - 1):
        out += [(f"unets.{u}.{n}", k, s)
                for n, k, s in _unet_layers(spec.in_ch, spec.in_ch, *args)]
    out += [(f"final_unet.{n}", k, s)
            for n, k, s in _unet_layers(spec.in_ch, spec.out_ch, *args)]
    out += [("head1", "dense", (128, spec.out_ch)),
            ("head2", "dense", (spec.n_params, 128))]
    return out


def param_shapes(spec: Spec) -> Dict[str, tuple]:
    """name -> shape of every parameter and BN buffer."""
    out = {}
    for name, kind, shape in layers(spec):
        if kind == "bn":
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{name}.{leaf}"] = shape
        else:
            out[f"{name}.weight"] = shape
            bias = shape[1] if kind == "tconv" else shape[0]
            out[f"{name}.bias"] = (bias,)
    out["scale"] = (1,)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


# ---------------------------------------------------------------------------
# Geometry and the carve.
# ---------------------------------------------------------------------------

def create_grid(spec: Spec) -> np.ndarray:
    offset = np.linspace(-spec.ell / 2, spec.ell / 2, spec.grid_size)
    gx, gy, gz = np.meshgrid(offset, offset, offset, indexing="ij")
    grid = np.stack([gx, gy, gz], axis=-1)
    (i1, i2), (i3, i4), (i5, i6) = spec.volume_idx
    return grid[i1:i2, i3:i4, i5:i6].astype(np.float32)


def project_points(points, K, E, eps=1e-8, clamp_z=False):
    """World points [N,3] -> pixels [C,N,2] for cameras K [C,3,3], E [C,4,4]."""
    pts_h = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    cam = torch.einsum("cij,nj->cni", E, pts_h)[..., :3]
    pix_h = torch.einsum("cij,cnj->cni", K, cam)
    z = pix_h[..., 2:3]
    denom = torch.clamp(z, min=eps) if clamp_z else z + eps
    return pix_h[..., :2] / denom


def camera_positions(E):
    return -torch.einsum("...ji,...j->...i", E[..., :3, :3], E[..., :3, 3])


def yaw_rotation(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _pixel_flat(pix, H: int, W: int):
    x = torch.clamp(torch.round(pix[..., 0]), 0, W - 1).long()
    y = torch.clamp(torch.round(pix[..., 1]), 0, H - 1).long()
    return y * W + x


def _nearest(images, flat):
    C, H, W, ch = images.shape
    return torch.gather(images.reshape(C, H * W, ch), 1,
                        flat[..., None].expand(-1, -1, ch))


def _frontmost(dists, flat, occupied):
    """[C,N] bool: occupied voxels nearest their camera on their pixel;
    one winner a pixel, ties to the lower voxel index (a stable sort by
    pixel, then distance)."""
    masked = torch.where(occupied[None, :], dists,
                         torch.full_like(dists, math.inf))
    key = (flat << 32) | masked.contiguous().view(torch.int32).long()
    order = torch.sort(key, dim=1, stable=True).indices
    p_s = torch.gather(flat, 1, order)
    first = torch.ones_like(p_s, dtype=torch.bool)
    first[:, 1:] = p_s[:, 1:] != p_s[:, :-1]
    vis_s = first & torch.isfinite(torch.gather(masked, 1, order))
    return torch.empty_like(vis_s).scatter_(1, order, vis_s) & occupied[None, :]


def carve(spec: Spec, grid, mask, img, center, angle, Ks, Es):
    """mask [C',H,W], img [C',H,W,3] of the observed views -> [4, n1, n2, n3]:
    occupancy and colour averaged over the thresholds 1 and (C'-1)/C'."""
    C = mask.shape[0]
    n1, n2, n3 = grid.shape[:3]
    rot = yaw_rotation(angle)
    pts = (torch.einsum("abci,ji->abcj", grid, rot)
           + center.reshape(1, 1, 1, 3)).reshape(-1, 3)
    H, W = img.shape[1], img.shape[2]
    pix = project_points(pts, Ks, Es, clamp_z=True)
    flat = _pixel_flat(pix, H, W)
    samp = _nearest(torch.cat([img, mask[..., None]], dim=-1), flat)
    sampled, mask_flat = samp[..., :3], samp[..., 3].mean(dim=0)
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


# ---------------------------------------------------------------------------
# The U-Nets.
# ---------------------------------------------------------------------------

def _bn(P: Params, name: str, x, train: bool):
    if train:
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + 1e-5) * P[f"{name}.weight"]
    return (x - mean.reshape(shape)) * mul.reshape(shape) + P[f"{name}.bias"].reshape(shape)


def _block(P, name, x, train):
    for k in (0, 1):
        x = F.conv3d(x, P[f"{name}.conv{k}.weight"], P[f"{name}.conv{k}.bias"],
                     padding=1)
        x = F.leaky_relu(_bn(P, f"{name}.bn{k}", x, train), 0.1)
    return x


def _pool(x):
    """2x2x2 max pool as successive 2-way maxes over d, h, w (the order
    fixes how a tie splits the gradient)."""
    b, c, d, h, w = x.shape
    x = x.reshape(b, c, d // 2, 2, h, w).amax(dim=3)
    x = x.reshape(b, c, d // 2, h // 2, 2, w).amax(dim=4)
    return x.reshape(b, c, d // 2, h // 2, w // 2, 2).amax(dim=5)


def _dense(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def unet_body(P: Params, pre: str, x, spec: Spec, train: bool):
    b, bf = x.shape[0], spec.bf
    enc = [_block(P, f"{pre}.encoder1", x, train)]
    for k in range(2, 6):
        enc.append(_block(P, f"{pre}.encoder{k}", _pool(enc[-1]), train))
    flat = enc[4].permute(0, 2, 3, 4, 1).reshape(b, -1)
    z = _dense(P, f"{pre}.mlp_1b", F.relu(_dense(P, f"{pre}.mlp_1a", flat)))
    v = (_dense(P, f"{pre}.mlp_2", z).reshape(b, *spec.ns, bf * 16)
         .permute(0, 4, 1, 2, 3))
    for k in (4, 3, 2, 1):
        up = F.conv_transpose3d(v, P[f"{pre}.upconv{k}.weight"],
                                P[f"{pre}.upconv{k}.bias"], stride=2)
        v = _block(P, f"{pre}.decoder{k}", torch.cat([enc[k - 1], up], 1), train)
    return F.conv3d(v, P[f"{pre}.final_conv.weight"], P[f"{pre}.final_conv.bias"])


def process_volume(P: Params, volume, spec: Spec, train: bool):
    """volume [4, n1, n2, n3] -> [out_ch, N]. A U-Net whose output width is
    its input width passes its input through (the hard passthrough of the
    first channels), so only the final U-Net's body reaches the output."""
    v = volume[None]
    for _ in range(spec.num_unets - 1):
        v = v + v
    out = unet_body(P, "final_unet", v, spec, train)
    v = torch.cat([v, out[:, spec.in_ch:]], dim=1)
    return v[0].reshape(spec.out_ch, -1)


# ---------------------------------------------------------------------------
# Selection and the Gaussian head.
# ---------------------------------------------------------------------------

def select(vol0, spec: Spec):
    """The adaptive threshold (up by delta while more than max_n values
    exceed mt + logit(pt), then down while fewer than min_n do, in float32)
    and the top max_n voxels in a stable descending order on float32's total
    order. Returns (indices, valid, probs)."""
    N = vol0.shape[0]
    bits = vol0.detach().contiguous().view(torch.int32)
    order = torch.sort(bits ^ ((bits >> 31) & 0x7FFFFFFF), descending=True,
                       stable=True).indices
    vals_sorted = vol0.index_select(0, order)
    host = vals_sorted.detach().cpu().numpy()
    n_top = int((bits > 0x7F800000).sum())
    f32 = np.float32
    lo_pos = n_top + spec.min_n - 1
    hi_pos = n_top + spec.max_n
    if lo_pos >= N or np.isnan(host[lo_pos]):
        raise ValueError("fewer than min_n counted occupancy values")
    v_lo = host[lo_pos]
    v_hi = host[hi_pos] if hi_pos < N and not np.isnan(host[hi_pos]) else -np.inf
    lp = f32(math.log(spec.pt / (1.0 - spec.pt)))
    mt, delta = f32(spec.mt), f32(spec.delta)
    while v_hi > f32(mt + lp):
        mt = f32(mt + delta)
    while not v_lo > f32(mt + lp):
        mt = f32(mt - delta)
    thr = float(f32(mt + lp))
    vals = vals_sorted[:spec.max_n]
    return order[:spec.max_n], vals > thr, torch.sigmoid(vals - float(mt))


def gaussians(P: Params, vol_flat, grid_flat, spec: Spec):
    """The head's Gaussians of the selected voxels (not yet posed)."""
    idx, valid, probs = select(vol_flat[0], spec)
    feats = vol_flat.T.index_select(0, idx)
    out = _dense(P, "head2", F.relu(_dense(P, "head1", feats)))
    pt = spec.pt
    logit_opac = torch.logit(torch.clamp((1.0 / (1.0 - pt)) * (probs - pt),
                                         1e-6, 1.0 - 1e-6))
    scale = P["scale"][0]
    lo, hi = spec.color_clip
    if spec.mode == "3d":
        quats, scales, _, colors, delta = torch.split(out, [4, 3, 1, 3, 3], dim=1)
        return dict(means=grid_flat[idx] + 2.0 * spec.voxel_size * torch.tanh(delta),
                    log_scales=scales + scale, quats=quats,
                    colors=torch.clamp(torch.sigmoid(colors), lo, hi),
                    logit_opacities=logit_opac, valid=valid)
    means2d, scales2d, rotation, colors, _ = torch.split(out, [2, 2, 1, 3, 1], dim=1)
    g = dict(means2d=means2d, log_scales2d=scales2d + scale,
             rotation=rotation[:, 0],
             colors=torch.clamp(torch.sigmoid(colors), lo, hi),
             logit_opacities=logit_opac, valid=valid)
    if spec.anchored:
        g["anchor_means"] = grid_flat[idx]
    return g


# ---------------------------------------------------------------------------
# Projection of 3D Gaussians.
# ---------------------------------------------------------------------------

def _quat_normalize(q, eps=1e-8):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def _quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def _quat_to_rotmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pose_3d(g, angle, p_3d):
    """Yaw-rotate and shift world Gaussians; quaternions composed with the
    yaw's and made w >= 0."""
    g = dict(g)
    g["means"] = g["means"] @ yaw_rotation(angle).T + p_3d
    half = 0.5 * angle
    z = torch.zeros_like(half)
    q_yaw = torch.stack([torch.cos(half), z, z, torch.sin(half)], -1)
    q = _quat_multiply(q_yaw[None, :], _quat_normalize(g["quats"]))
    g["quats"] = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return g


def project_gaussians(means, quats, scales, viewmat, K, width, height,
                      near=0.01, far=1e10, eps2d=0.3):
    """EWA projection into cameras viewmat [B,4,4], K [B,3,3]: mean2d
    [B,N,2], conic [B,N,3], depth, radius (ceil of 3 sigma of the larger
    eigenvalue) and valid [B,N]."""
    viewmat, K = viewmat[:, None], K[:, None]
    Rcw, tcw = viewmat[..., :3, :3], viewmat[..., :3, 3]
    wx, wy, wz = means[:, 0], means[:, 1], means[:, 2]
    mcx = Rcw[..., 0, 0] * wx + Rcw[..., 0, 1] * wy + Rcw[..., 0, 2] * wz + tcw[..., 0]
    mcy = Rcw[..., 1, 0] * wx + Rcw[..., 1, 1] * wy + Rcw[..., 1, 2] * wz + tcw[..., 1]
    depth = Rcw[..., 2, 0] * wx + Rcw[..., 2, 1] * wy + Rcw[..., 2, 2] * wz + tcw[..., 2]
    M = _quat_to_rotmat(_quat_normalize(quats)) * scales[..., None, :]
    m0, m1, m2 = M[:, 0], M[:, 1], M[:, 2]

    def row(i):
        c = Rcw[..., i, :, None]
        return c[..., 0, :] * m0 + c[..., 1, :] * m1 + c[..., 2, :] * m2

    a0, a1, a2 = row(0), row(1), row(2)
    c00, c01, c02 = (a0 * a0).sum(-1), (a0 * a1).sum(-1), (a0 * a2).sum(-1)
    c11, c12, c22 = (a1 * a1).sum(-1), (a1 * a2).sum(-1), (a2 * a2).sum(-1)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    tan_fovx, tan_fovy = 0.5 * width / fx, 0.5 * height / fy
    z = depth
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    lx, ly = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(mcx / safe_z, -lx), lx) * z
    ty = torch.minimum(torch.maximum(mcy / safe_z, -ly), ly) * z
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a = j00 * (j00 * c00 + 2.0 * j02 * c02) + j02 * j02 * c22 + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + 2.0 * j12 * c12) + j12 * j12 * c22 + eps2d
    det = a * c - b * b
    safe_det = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c / safe_det, -b / safe_det, a / safe_det], -1)
    mean2d = torch.stack([fx * mcx * inv_z + cx, fy * mcy * inv_z + cy], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(
        torch.clamp(mid * mid - det, min=0.01))))
    inside = ((mean2d[..., 0] + radius > 0) & (mean2d[..., 0] - radius < width)
              & (mean2d[..., 1] + radius > 0) & (mean2d[..., 1] - radius < height))
    valid = (depth > near) & (depth < far) & (det > 0) & (radius > 0.0) & inside
    return mean2d, conic, depth, radius, valid


# ---------------------------------------------------------------------------
# Binning and compositing.
# ---------------------------------------------------------------------------

def _pack(cols, n_used: int):
    pads = torch.zeros(cols[0].shape[:-1] + (FEATS - n_used,),
                       dtype=cols[0].dtype, device=cols[0].device)
    return torch.cat(list(cols) + [pads], dim=-1)


def bin_rows(center, radius, valid, H: int, W: int, expand: int):
    """Instance rows of B cameras' Gaussians (in compositing order) in
    (8, 128) tiles, each tile's rows a segment of whole 64-row chunks.

    Returns (rows [B, N*expand] destination row of each (Gaussian, slot)
    or -1, src [B, N*expand] its Gaussian, astarts, counts [B, T], mcap,
    overflow []): a Gaussian takes the tiles of its circle's bounding box
    in row-major order, at most ``expand`` of them; a camera holds at most
    4N + T·64 rows, and rows past it are dropped. Both drops are counted.
    """
    th, tw = TILE
    G = CHUNK
    n_ty, n_tx = -(-H // th), -(-W // tw)
    T = n_ty * n_tx
    B, N = radius.shape
    dev = radius.device
    cap = 4 * N + T * G
    mcap = min(-(-(N * expand) // G) * G + T * G, -(-cap // G) * G)
    cx, cy = center[..., 0], center[..., 1]
    r = torch.where(valid, radius, torch.zeros_like(radius))
    overlap = (valid & (cx + r >= 0) & (cx - r < n_tx * tw)
               & (cy + r >= 0) & (cy - r < n_ty * th))
    cx = torch.where(overlap, cx, torch.zeros_like(cx))
    cy = torch.where(overlap, cy, torch.zeros_like(cy))
    x0 = torch.clamp(torch.floor((cx - r) / tw), 0, n_tx - 1).long()
    x1 = torch.clamp(torch.floor((cx + r) / tw), 0, n_tx - 1).long()
    y0 = torch.clamp(torch.floor((cy - r) / th), 0, n_ty - 1).long()
    y1 = torch.clamp(torch.floor((cy + r) / th), 0, n_ty - 1).long()
    wspan = torch.clamp(x1 - x0 + 1, min=1)
    hspan = torch.clamp(y1 - y0 + 1, min=1)
    span = torch.where(overlap, wspan * hspan, torch.zeros_like(wspan))
    live_n = torch.clamp(span, max=expand)
    dropped = (span - live_n).sum()
    e = torch.arange(expand, device=dev)
    live = e < live_n[..., None]                     # [B,N,E]
    tile = (y0[..., None] + e // wspan[..., None]) * n_tx + x0[..., None] \
        + e % wspan[..., None]
    rows = torch.full((B, N, expand), -1, dtype=torch.long, device=dev)
    astarts = torch.zeros((B, T), dtype=torch.long, device=dev)
    counts = torch.zeros((B, T), dtype=torch.long, device=dev)
    for b in range(B):
        t_live = tile[b][live[b]]                    # slots in (Gaussian, e) order
        cnt = torch.bincount(t_live, minlength=T)
        starts = G * torch.cumsum((cnt + G - 1) // G, 0) - G * ((cnt + G - 1) // G)
        order = torch.sort(t_live, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=dev) - (
            torch.cumsum(cnt, 0) - cnt)[t_live[order]]
        row = starts[t_live] + rank
        kept = row < mcap
        dropped = dropped + (~kept).sum()
        rows_b = torch.full_like(t_live, -1)
        rows_b[kept] = row[kept]
        rows[b][live[b]] = rows_b
        astarts[b] = torch.clamp(starts, max=max(mcap - G, 0))
        counts[b] = torch.minimum(cnt, torch.clamp(mcap - starts, min=0))
    src = torch.arange(N, device=dev)[None, :, None].expand(B, N, expand)
    return (rows.reshape(B, -1), src.reshape(B, -1), astarts, counts, mcap,
            dropped)


def gather_rows(packed, rows, src, mcap: int):
    """[B,N,16] packed Gaussians -> [B*mcap, 16] instance rows (zero where
    no slot lands), differentiable in ``packed``."""
    B, N, nf = packed.shape
    out = []
    for b in range(B):
        keep = rows[b] >= 0
        idx = torch.full((mcap,), N, dtype=torch.long, device=packed.device)
        idx[rows[b][keep]] = src[b][keep]
        padded = torch.cat([packed[b], packed.new_zeros((1, nf))], 0)
        out.append(padded.index_select(0, idx))
    return torch.cat(out, 0)


def _alpha(mode: str, f, xs, ys, rowmask):
    dx = xs - f[..., 0:1]
    dy = ys - f[..., 1:2]
    opacity = f[..., 6:7]
    if mode == "conic":
        A, B, C = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
        raw = opacity * torch.exp(-sigma)
        live = (sigma >= 0) & (raw >= ALPHA_SKIP) & rowmask
        return torch.where(live, torch.clamp(raw, max=ALPHA_CLAMP),
                           torch.zeros_like(raw))
    c, s = f[..., 2:3], f[..., 3:4]
    sx, sy = f[..., 4:5], f[..., 5:6]
    u = c * dx + s * dy
    v = -s * dx + c * dy
    sx2 = 2.0 * sx * sx + 1e-8
    sy2 = 2.0 * sy * sy + 1e-8
    e = torch.exp(-(u * u / sx2 + v * v / sy2))
    return torch.where(rowmask, opacity * e, torch.zeros_like(e))


def composite(inst, astarts, counts, origins, mode: str):
    """Front to back over each tile's rows, 64 a chunk, every tile at once:
    T = T_in · exclusive cumprod(1 - a); in conic mode a contribution
    counts only where T·(1 - a) >= 1e-4 (once a tile's T is below 1e-4
    everywhere nothing more counts). Returns rgb [T,3,P], alpha [T,P]."""
    th, tw = TILE
    G = CHUNK
    P = th * tw
    nt = astarts.shape[0]
    dev = inst.device
    pidx = torch.arange(P, device=dev)
    off = PIXEL_OFFSET[mode]
    xs = origins[:, 1:2].float() + (pidx % tw).float() + off
    ys = origins[:, 0:1].float() + (pidx // tw).float() + off
    steps = (counts + G - 1) // G
    t_in = torch.ones((nt, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((nt, 4, P), dtype=torch.float32, device=dev)
    rows_g = torch.arange(G, device=dev)
    for j in range(int(steps.max()) if nt else 0):
        act = torch.nonzero(steps > j).reshape(-1)
        rowmask = rows_g[None, :] < (counts[act] - j * G)[:, None]
        rows = astarts[act, None] + j * G + rows_g[None, :]
        f = inst[torch.where(rowmask, rows, torch.zeros_like(rows))]
        a = _alpha(mode, f, xs[act, None, :], ys[act, None, :], rowmask[..., None])
        cp = torch.cumprod(1.0 - a, dim=1)
        T = t_in[act][:, None, :] * torch.cat([torch.ones_like(cp[:, :1]),
                                               cp[:, :-1]], dim=1)
        contrib = a * T
        if mode == "conic":
            contrib = torch.where(T * (1.0 - a) >= STOP_T, contrib,
                                  torch.zeros_like(contrib))
        part = torch.stack([(contrib * f[..., 7:8]).sum(1),
                            (contrib * f[..., 8:9]).sum(1),
                            (contrib * f[..., 9:10]).sum(1),
                            contrib.sum(1)], dim=1)
        acc = acc.index_add(0, act, part)
        t_in = t_in.index_copy(0, act, t_in[act] * cp[:, -1])
    return acc[:, :3], acc[:, 3]


def _tiles(B: int, H: int, W: int, device):
    th, tw = TILE
    n_ty, n_tx = -(-H // th), -(-W // tw)
    ys = torch.arange(n_ty, device=device) * th
    xs = torch.arange(n_tx, device=device) * tw
    origins = torch.stack([ys.repeat_interleave(n_tx), xs.repeat(n_ty)], -1)
    return origins.repeat(B, 1), n_ty, n_tx


def render_rows(packed, center, radius, valid, mode: str, H: int, W: int,
                expand: int):
    """Bin and composite B cameras; returns rgb [B,H,W,3], alpha [B,H,W] and
    the dropped-row count."""
    B = packed.shape[0]
    packed = torch.where(valid[..., None], packed, torch.zeros_like(packed))
    rows, src, astarts, counts, mcap, dropped = bin_rows(
        center.detach(), radius.detach(), valid, H, W, expand)
    inst = gather_rows(packed, rows, src, mcap)
    offs = (torch.arange(B, device=packed.device) * mcap)[:, None]
    origins, n_ty, n_tx = _tiles(B, H, W, packed.device)
    rgb_t, alpha_t = composite(inst, (astarts + offs).reshape(-1),
                               counts.reshape(-1), origins, mode)
    th, tw = TILE
    rgb = (rgb_t.reshape(B, n_ty, n_tx, 3, th, tw).permute(0, 1, 4, 2, 5, 3)
           .reshape(B, n_ty * th, n_tx * tw, 3)[:, :H, :W])
    alpha = (alpha_t.reshape(B, n_ty, n_tx, th, tw).permute(0, 1, 3, 2, 4)
             .reshape(B, n_ty * th, n_tx * tw)[:, :H, :W])
    return rgb, alpha, dropped


# ---------------------------------------------------------------------------
# The whole forward.
# ---------------------------------------------------------------------------

class Cameras:
    """The rig on a device: K [C,3,3], E [C,4,4], the observed views'."""

    def __init__(self, Ks, Es, spec: Spec):
        self.Ks, self.Es = Ks, Es
        obs = torch.as_tensor(spec.observed, device=Ks.device)
        self.Ks_obs, self.Es_obs = Ks[obs], Es[obs]


def forward(P: Params, spec: Spec, cams: Cameras, grid, mask, img, p_3d,
            angle, view: int, train: bool):
    """One frame rendered to camera ``view``: rgb [H,W,3], alpha [H,W] and
    the dropped-row count."""
    volume = carve(spec, grid, mask, img, p_3d, angle, cams.Ks_obs, cams.Es_obs)
    vol_flat = process_volume(P, volume, spec, train)
    g = gaussians(P, vol_flat, grid.reshape(-1, 3), spec)
    bg = torch.tensor(spec.background, dtype=torch.float32, device=img.device)
    K, E = cams.Ks[view:view + 1], cams.Es[view:view + 1]
    if spec.mode == "3d":
        g = pose_3d(g, angle, p_3d)
        mean2d, conic, depth, radius, ok = project_gaussians(
            g["means"], g["quats"], torch.exp(g["log_scales"]), E, K,
            spec.W, spec.H)
        ok = ok & g["valid"][None, :]
        keys = torch.where(ok, depth, torch.full_like(depth, math.inf))
        order = torch.sort(keys, dim=1, stable=True).indices[0]
        opac = torch.sigmoid(g["logit_opacities"])
        packed = _pack([mean2d[0], conic[0], torch.zeros_like(opac[:, None]),
                        opac[:, None], g["colors"], radius[0][:, None]], 11)
        packed = packed.index_select(0, order)[None]
        rgb, alpha, dropped = render_rows(
            packed, packed[..., 0:2], packed[..., 10], ok[0][order][None],
            "conic", spec.H, spec.W, spec.tile_expand)
    else:
        rot = yaw_rotation(angle)
        anchors = g["anchor_means"] @ rot.T + p_3d
        means = project_points(anchors, K, E, clamp_z=True) + g["means2d"][None]
        scales = torch.exp(g["log_scales2d"])
        radius = spec.sigma_cutoff * torch.maximum(scales[:, 0], scales[:, 1])
        th = g["rotation"]
        packed = _pack([means, torch.cos(th)[None, :, None],
                        torch.sin(th)[None, :, None], scales[None],
                        torch.sigmoid(g["logit_opacities"])[None, :, None],
                        g["colors"][None], radius[None, :, None]], 11)
        rgb, alpha, dropped = render_rows(packed, means, radius[None],
                                          g["valid"][None], "ellipse",
                                          spec.H, spec.W, spec.tile_expand)
    rgb = rgb + (1.0 - alpha[..., None]) * bg.reshape(1, 1, 1, 3)
    return rgb[0], alpha[0], dropped
