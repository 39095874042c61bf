"""Visual-pose features: spherical rendering → ResNet18 → SH power (stage
1); counterpart of ``pose_splatter_tpu/preprocess/visual_features.py``.

- spherical camera rig: Gauss-Legendre polar nodes (N_θ = L+1) × uniform
  azimuth (N_φ = 2(L+1)), look-at extrinsics, fov 7.5°, 224²;
- SH projection matrix A [(L+1)², N_θ·N_φ] from conjugate spherical
  harmonics with quadrature weights (numpy and scipy, copied);
- per frame: carve → U-Nets → Gaussians, centre the means, rotate the
  means (not the quaternions, as the reference does) by a random yaw, splat
  to the rig in one batched-camera ``rasterize`` (the forward compositor on
  the card), ResNet18 features, ``|A · f|`` → [(L+1)², 512], cast to
  float16 on the host.

Each stage ends in a mark (``utils/stages.py``): "carve", "unets",
"select_head", the splat's "binning" (projection, depth sort, binning),
"kernel" (the compositor) and "untile", then "resnet" (its value, while
recording, is the [V, 224, 224, 3] renders that ResNet18 read) and "sh".
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pose_splatter_torch.models.resnet import create_feature_extractor
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.cameras import camera_extrinsic_spherical
from pose_splatter_torch.utils.geometry import yaw_rotation

RIG_SIZE = 224  # the rig's width and height in pixels


def _sph_harm(m, ell, phi, theta):
    """Y_l^m(θ, φ) with θ polar, φ azimuth, across scipy versions."""
    try:
        from scipy.special import sph_harm_y

        return sph_harm_y(ell, m, theta, phi)
    except ImportError:  # older scipy
        from scipy.special import sph_harm

        return sph_harm(m, ell, phi, theta)


def spherical_rig(
    L: int = 3, radius: float = 1.0, fov_deg: float = 7.5,
    width: int = RIG_SIZE, height: int = RIG_SIZE,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build the rig. Returns (Ks [V,3,3], viewmats [V,4,4], thetas, phis,
    leggauss weights) with V = (L+1)·2(L+1)."""
    n_theta = L + 1
    n_phi = 2 * n_theta
    x, weights = np.polynomial.legendre.leggauss(n_theta)
    thetas = np.arccos(x)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)

    f = 0.5 * width / np.tan(fov_deg / 360 * np.pi)
    K = np.array([[f, 0.0, width / 2], [0, f, height / 2], [0, 0, 1]])
    Ks = np.tile(K[None], (n_theta * n_phi, 1, 1)).astype(np.float32)

    viewmats = np.zeros((n_theta, n_phi, 4, 4), np.float32)
    for i, th in enumerate(thetas):
        for j, ph in enumerate(phis):
            viewmats[i, j] = camera_extrinsic_spherical(radius, th, ph)
    return Ks, viewmats.reshape(-1, 4, 4), thetas, phis, weights


def build_A(L: int, w: np.ndarray, thetas: np.ndarray, phis: np.ndarray
            ) -> np.ndarray:
    """SH projection matrix [(L+1)², N_θ·N_φ] (complex64), row (ell, m),
    column (k, j), entries  w_k·Δφ·conj(Y_ℓ^m(θ_k, φ_j))."""
    n_theta, n_phi = len(thetas), len(phis)
    dphi = 2.0 * np.pi / n_phi
    A = np.zeros(((L + 1) ** 2, n_theta * n_phi), dtype=complex)
    row = 0
    for ell in range(L + 1):
        for m in range(-ell, ell + 1):
            for k in range(n_theta):
                weight = w[k] * dphi
                for j in range(n_phi):
                    A[row, k * n_phi + j] = weight * np.conjugate(
                        _sph_harm(m, ell, phis[j], thetas[k])
                    )
            row += 1
    return A.astype(np.complex64)


def sh_invariant_features(features: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """[V, 512] per-view features → [(L+1)², 512] rotation-invariant
    moduli: a complex64 product, as the JAX einsum."""
    return torch.abs(A @ features.to(torch.complex64))


def make_frame_features(
    model, L: int = 3, resnet_weights: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """The per-frame function of :func:`calculate_visual_features` on the
    model's device: ``fn(mask, img, p_3d, angle, theta)`` → float32
    [(L+1)², 512]. ``generator`` draws ResNet18's weights when
    ``resnet_weights`` is None."""
    dev = model.device
    Ks, viewmats, thetas, phis, weights = spherical_rig(L)
    A = torch.as_tensor(build_A(L, weights, thetas, phis), device=dev)
    Ks_t = torch.as_tensor(Ks, device=dev)
    views_t = torch.as_tensor(viewmats, device=dev)
    extract, _ = create_feature_extractor(resnet_weights, dev, generator)

    @torch.no_grad()
    def frame_features(mask, img, p_3d, angle, theta) -> torch.Tensor:
        g, _ = model.frame_gaussians(mask, img, p_3d, angle)
        stages.end("select_head", g)
        means = g["means"] - g["means"].mean(dim=0, keepdim=True)
        means = means @ yaw_rotation(theta, device=dev).T
        rgb, _ = model.splat(
            means, g["quats"], torch.exp(g["log_scales"]),
            torch.sigmoid(g["logit_opacities"]), g["colors"], views_t, Ks_t,
            RIG_SIZE, RIG_SIZE, valid=g["valid"])  # [V, H, W, 3]
        rgb = torch.clamp(rgb, 0, 1)
        feats = extract(rgb)  # [V, 512]
        stages.mark("resnet", rgb)
        out = sh_invariant_features(feats, A)
        stages.mark("sh")
        return out

    return frame_features


def calculate_visual_features(
    config,
    model,
    dataset,
    resnet_weights: Optional[str] = None,
    L: int = 3,
    dry_run: bool = False,
    seed: int = 0,
    progress: bool = True,
) -> np.ndarray:
    """Stage-1 entry point (``:90-157``): per frame render the spherical
    rig and extract SH-invariant ResNet features, on the model's device. Returns
    [T, (L+1)², 512] float16 and writes ``config.feature_fn``. The yaw θ
    is drawn once a frame from ``np.random.default_rng(seed)`` (0 with
    ``dry_run``, which stops after one frame and writes nothing). The
    model's own weights are used; ResNet18's come from ``resnet_weights``
    or start as Flax's do (generator seeded 0)."""
    frame_features = make_frame_features(model, L, resnet_weights)
    rng = np.random.default_rng(seed)
    all_features = []
    for i in range(len(dataset)):
        mask, img, p_3d, angle, _ = dataset.get(i, view_idx=0)
        theta = 0.0 if dry_run else 2 * np.pi * rng.random()
        f = frame_features(mask, img, p_3d, np.float32(angle),
                           np.float32(theta))
        all_features.append(f.cpu().numpy().astype(np.float16))
        if dry_run:
            break
        if progress and (i + 1) % 100 == 0:
            print(f"  visual features: {i + 1}/{len(dataset)}")

    out = np.array(all_features)
    if not dry_run:
        np.save(config.feature_fn, out)
    return out
