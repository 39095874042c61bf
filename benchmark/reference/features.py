"""Plain PyTorch forward of the visual-pose feature stage, over flat
parameter dicts.

The stage as Pose Splatter's reference code describes it
(arXiv:2505.18342, ``scripts/preprocessing/calculate_visual_features.py``)
on ResNet-18 (He et al., arXiv:1512.03385, as torchvision's ``resnet18``
before its ``fc``):

    the model's Gaussians of a frame (``model.py``: carve -> U-Nets ->
    selection -> head) -> means centred on their mean and turned by a yaw
    theta -> one render of a spherical rig: Gauss-Legendre polar nodes
    (L + 1) x 2(L + 1) uniform azimuths, each camera on a sphere of
    ``radius`` looking at the origin, ``size``^2 pixels, field of view
    ``fov_deg``, white background by transmittance, clipped to [0, 1] ->
    ImageNet normalisation -> ResNet-18 (7x7/2 stem, BatchNorm on running
    statistics, 3x3/2 max-pool, 4 stages of 2 BasicBlocks at 64 / 128 /
    256 / 512, global mean) -> |A f| with A the (L + 1)^2 conjugate
    spherical harmonics at the nodes times the quadrature weights.

Float32 throughout, with TF32 off as the program sets it (a caller that
wants the precision below switches TF32 on around it). Departures from the
published description, each the port's and the JAX package's too:

- the Gaussians are those of the render path's model (``model.py``), posed
  only by the carve: the rig renders the head's means centred and turned,
  their quaternions unturned, as the published code does;
- the render is the benchmark's instance binning and front-to-back
  compositing (``model.render_rows``, conic mode, (8, 128) tiles) in place
  of gsplat's 16x16 tiles, each Gaussian culled below a radius of 2 pixels
  as gsplat's ``radius_clip`` does; the binning's caps (``tile_expand``
  tiles a Gaussian, ``instance_cap`` rows a camera) are the
  configuration's, and what they drop is counted;
- ResNet-18's weights are a seeded draw (ImageNet's are not in the
  repository), so the features carry no meaning beyond the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import (
    CHUNK,
    TILE,
    Cameras,
    Params,
    Spec,
    _pack,
    carve,
    gaussians,
    process_volume,
    project_gaussians,
    render_rows,
    yaw_rotation,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RADIUS_CLIP = 2.0
BN_EPS = 1e-5


def resnet_layers() -> List[Tuple[str, int, int, int, int]]:
    """ResNet-18's convolutions: (name, in, out, kernel, stride), each
    followed by the BatchNorm named as torchvision names it."""
    out = [("conv1", 3, 64, 7, 2)]
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512), start=1):
        for block in (0, 1):
            stride = 2 if stage > 1 and block == 0 else 1
            pre = f"layer{stage}.{block}"
            out.append((f"{pre}.conv1", cin, width, 3, stride))
            out.append((f"{pre}.conv2", width, width, 3, 1))
            if stride != 1 or cin != width:
                out.append((f"{pre}.downsample.0", cin, width, 1, stride))
            cin = width
    return out


def bn_name(conv: str) -> str:
    """The BatchNorm after a convolution, by torchvision's names."""
    if conv.endswith("downsample.0"):
        return conv[:-1] + "1"
    return conv[:-5] + "bn" + conv[-1]


class Rig:
    """The spherical rig of a ``visual_features`` block on ``device``:
    Ks [V,3,3], Es [V,4,4] float32, the SH matrix's real and imaginary
    parts [(L+1)^2, V], and the binning's caps."""

    def __init__(self, block: dict, device):
        self.L = int(block.get("L", 3))
        self.size = int(block.get("size", 224))
        self.fov_deg = float(block.get("fov_deg", 7.5))
        self.radius = float(block.get("radius", 1.0))
        self.tile_expand = int(block.get("tile_expand") or 16)
        cap = block.get("instance_cap")
        self.instance_cap = None if cap is None else int(cap)
        n_theta, n_phi = self.L + 1, 2 * (self.L + 1)
        nodes, weights = np.polynomial.legendre.leggauss(n_theta)
        thetas = np.arccos(nodes)
        phis = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
        f = 0.5 * self.size / math.tan(math.radians(self.fov_deg) / 2.0)
        K = np.array([[f, 0.0, self.size / 2], [0.0, f, self.size / 2],
                      [0.0, 0.0, 1.0]])
        Es = [look_at_origin(self.radius, th, ph) for th in thetas for ph in phis]
        V = len(Es)
        self.Ks = torch.as_tensor(np.tile(K[None], (V, 1, 1)), dtype=torch.float32,
                                  device=device)
        self.Es = torch.as_tensor(np.stack(Es), dtype=torch.float32, device=device)
        A = sh_matrix(self.L, thetas, phis, weights)
        self.A_re = torch.as_tensor(A.real, dtype=torch.float32, device=device)
        self.A_im = torch.as_tensor(A.imag, dtype=torch.float32, device=device)


def look_at_origin(radius: float, theta: float, phi: float) -> np.ndarray:
    """[4,4] world-to-camera (OpenCV: x right, y down, z forward) of a
    camera at polar angle theta and azimuth phi on a sphere, looking at the
    origin, its image's up along -z."""
    C = radius * np.array([math.sin(theta) * math.cos(phi),
                           math.sin(theta) * math.sin(phi), math.cos(theta)])
    forward = -C / np.linalg.norm(C)
    right = np.cross([0.0, 0.0, -1.0], forward)
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    down = down / np.linalg.norm(down)
    R = np.stack([right, down, forward])
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ C
    return E


def _legendre(ell: int, m: int, x: float) -> float:
    """Associated Legendre P_ell^m(x), m >= 0, with the Condon-Shortley
    phase, by the standard recurrences."""
    pmm = 1.0
    s = math.sqrt((1.0 - x) * (1.0 + x))
    for i in range(m):
        pmm *= -(2 * i + 1) * s
    if ell == m:
        return pmm
    pm1 = x * (2 * m + 1) * pmm
    for n in range(m + 2, ell + 1):
        pmm, pm1 = pm1, ((2 * n - 1) * x * pm1 - (n + m - 1) * pmm) / (n - m)
    return pm1


def spherical_harmonic(ell: int, m: int, theta: float, phi: float) -> complex:
    """Y_ell^m at polar angle theta and azimuth phi, orthonormal on the
    sphere."""
    a = abs(m)
    norm = math.sqrt((2 * ell + 1) / (4 * math.pi)
                     * math.factorial(ell - a) / math.factorial(ell + a))
    y = norm * _legendre(ell, a, math.cos(theta)) * complex(math.cos(a * phi),
                                                            math.sin(a * phi))
    return y if m >= 0 else (-1) ** a * y.conjugate()


def sh_matrix(L: int, thetas, phis, weights) -> np.ndarray:
    """[(L+1)^2, N_theta * N_phi] complex: row (ell, m), column (k, j),
    w_k * dphi * conj(Y_ell^m(theta_k, phi_j))."""
    dphi = 2.0 * math.pi / len(phis)
    rows = []
    for ell in range(L + 1):
        for m in range(-ell, ell + 1):
            rows.append([weights[k] * dphi * spherical_harmonic(ell, m, th, ph)
                         .conjugate() for k, th in enumerate(thetas) for ph in phis])
    return np.asarray(rows, dtype=np.complex128)


def render_rig(g: Dict[str, torch.Tensor], means, rig: Rig):
    """The rig's render of Gaussians ``g`` at ``means``: rgb [V,S,S,3] on
    white, clipped to [0, 1], and the rows the caps dropped (the binning's
    count: the tiles past ``tile_expand`` and the rows past the cap)."""
    S = rig.size
    n = means.shape[0]
    mean2d, conic, depth, radius, ok = project_gaussians(
        means, g["quats"], torch.exp(g["log_scales"]), rig.Es, rig.Ks, S, S)
    ok = ok & (radius > RADIUS_CLIP) & g["valid"][None, :]
    order = torch.sort(torch.where(ok, depth, torch.full_like(depth, math.inf)),
                       dim=1, stable=True).indices
    V = order.shape[0]
    opac = torch.sigmoid(g["logit_opacities"])[None, :, None].expand(V, n, 1)
    packed = _pack([mean2d, conic, torch.zeros_like(opac), opac,
                    g["colors"][None].expand(V, n, 3), radius[..., None]], 11)
    packed = torch.gather(packed, 1, order[..., None].expand(-1, -1, packed.shape[-1]))
    ok = torch.gather(ok, 1, order)
    # ``render_rows`` holds 4n + T*G rows a camera; Gaussians appended past
    # the last (invalid, so in no tile) raise that to the rig's cap.
    n_ty, n_tx = -(-S // TILE[0]), -(-S // TILE[1])
    T = n_ty * n_tx
    cap = rig.instance_cap if rig.instance_cap is not None else 4 * n + T * CHUNK
    pad = (cap - T * CHUNK) // 4 - n
    if pad < 0 or 4 * (n + pad) + T * CHUNK != cap:
        raise ValueError(f"instance_cap {cap}: not 4n' + T*G for any n' >= {n}")
    packed = torch.cat([packed, packed.new_zeros((V, pad, packed.shape[-1]))], 1)
    ok = torch.cat([ok, ok.new_zeros((V, pad))], 1)
    rgb, alpha, dropped = render_rows(packed, packed[..., 0:2], packed[..., 10], ok,
                                      "conic", S, S, rig.tile_expand)
    return torch.clamp(rgb + (1.0 - alpha[..., None]), 0.0, 1.0), int(dropped)


def _bn(R: Params, name: str, x):
    mul = torch.rsqrt(R[f"{name}.running_var"] + BN_EPS) * R[f"{name}.weight"]
    shift = R[f"{name}.bias"] - R[f"{name}.running_mean"] * mul
    return x * mul[None, :, None, None] + shift[None, :, None, None]


def resnet18(R: Params, images):
    """images [B,S,S,3] in [0, 1] -> [B, 512]: ImageNet normalisation, then
    ResNet-18 up to its global mean (weights by torchvision's names)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)

    def conv(name, x, stride, k):
        return _bn(R, bn_name(name), F.conv2d(x, R[f"{name}.weight"], stride=stride,
                                              padding=k // 2))

    x = F.max_pool2d(F.relu(conv("conv1", x, 2, 7)), 3, 2, 1)
    for stage in range(1, 5):
        for block in (0, 1):
            pre = f"layer{stage}.{block}"
            stride = 2 if stage > 1 and block == 0 else 1
            y = F.relu(conv(f"{pre}.conv1", x, stride, 3))
            y = conv(f"{pre}.conv2", y, 1, 3)
            if f"{pre}.downsample.0.weight" in R:
                x = conv(f"{pre}.downsample.0", x, stride, 1)
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def sh_power(rig: Rig, feats):
    """|A f|: [(L+1)^2, 512] from per-view features [V, 512]."""
    return torch.sqrt((rig.A_re @ feats) ** 2 + (rig.A_im @ feats) ** 2)


@torch.no_grad()
def frame_features(P: Params, R: Params, spec: Spec, cams: Cameras, grid,
                   rig: Rig, mask, img, p_3d, angle, theta: float):
    """One frame's features [(L+1)^2, 512] float32 and the rows the rig's
    binning dropped."""
    volume = carve(spec, grid, mask, img, p_3d, angle, cams.Ks_obs, cams.Es_obs)
    vol_flat = process_volume(P, volume, spec, train=False)
    g = gaussians(P, vol_flat, grid.reshape(-1, 3), spec)
    means = g["means"] - g["means"].mean(dim=0, keepdim=True)
    turn = torch.as_tensor(theta, dtype=torch.float32, device=means.device)
    means = means @ yaw_rotation(turn).T
    rgb, dropped = render_rig(g, means, rig)
    return sh_power(rig, resnet18(R, rgb)), dropped


def features(P: Params, R: Params, spec: Spec, cams: Cameras, grid, rig: Rig,
             frames: Sequence[Dict], thetas: Sequence[float]) -> List[torch.Tensor]:
    """Each frame's features at its theta."""
    return [frame_features(P, R, spec, cams, grid, rig, f["mask"], f["img"],
                           f["p_3d"], f["angle"], t)[0]
            for f, t in zip(frames, thetas)]
