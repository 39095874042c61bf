"""Temporal pose tracking: principal-axis estimation with sign continuity.

A copy of ``pose_splatter_tpu/tracking.py`` (numpy only), kept so that the
port imports nothing of the JAX package.

Behavior parity with the reference (its ``src/tracking.py:11-114``):
per-frame largest eigenvector of the carved volume's covariance; the sign
ambiguity between consecutive frames is resolved by transporting the tracked
axis tip through the W2-optimal-transport map between consecutive Gaussians
``T(x) = μ₂ + A(x − μ₁)``, ``A = Σ₂^½ (Σ₂^½ Σ₁ Σ₂^½)^(−½) Σ₂^½``; the global
sign is fixed by correlating the axes with the direction of motion.

This implementation vectorizes the whole trajectory instead of looping: all
T eigendecompositions, all T−1 transport matrices, and all consecutive-pair
sign agreements are batched ``eigh``/``matmul`` calls, and the sequential
sign recurrence collapses to a cumulative product — because the transport
map is linear, the frame-(t+1) sign is
``s_{t+1} = s_t · sign(⟨A_t v_t, v_{t+1}⟩)``, so the per-pair agreements
``c_t`` fully determine ``s = cumprod(c)``. Host-side NumPy (tiny 3×3
problems; not device work).
"""

from __future__ import annotations

import numpy as np


def _eigh_sqrt(mats: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Batched symmetric matrix square root ``M^½`` (or ``M^{-½}``)."""
    vals, vecs = np.linalg.eigh(mats)
    vals = np.clip(vals, 0.0, None)
    d = np.sqrt(vals)
    if inverse:
        d = 1.0 / np.maximum(d, 1e-12)
    return np.einsum("...ij,...j,...kj->...ik", vecs, d, vecs)


def principal_axes(covariances: np.ndarray) -> np.ndarray:
    """Batched unit largest-eigenvectors: [T, n, n] → [T, n] (sign-free)."""
    _, vecs = np.linalg.eigh(covariances)  # ascending
    v = vecs[..., -1]
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def transport_matrices(covariances: np.ndarray) -> np.ndarray:
    """W2-optimal-transport linear maps between consecutive Gaussians.

    Returns A [T−1, n, n] with ``A_t = Σ_{t+1}^½ (Σ_{t+1}^½ Σ_t
    Σ_{t+1}^½)^{-½} Σ_{t+1}^½`` so that ``x ↦ μ_{t+1} + A_t (x − μ_t)``
    pushes N(μ_t, Σ_t) onto N(μ_{t+1}, Σ_{t+1})."""
    s2 = _eigh_sqrt(covariances[1:])  # Σ_{t+1}^½
    inner = s2 @ covariances[:-1] @ s2
    return s2 @ _eigh_sqrt(inner, inverse=True) @ s2


def optimal_transport_map(mean1, cov1, mean2, cov2, x):
    """Apply the two-Gaussian W2 transport map to point(s) ``x``."""
    A = transport_matrices(np.stack([cov1, cov2]))[0]
    return mean2 + (A @ (np.asarray(x) - mean1).T).T.reshape(np.shape(x))


def track_principal_axes(means: np.ndarray,
                         covariances: np.ndarray) -> np.ndarray:
    """means [T, n], covariances [T, n, n] → sign-consistent axes [T, n]."""
    means = np.asarray(means, dtype=np.float64)
    covariances = np.asarray(covariances, dtype=np.float64)
    v = principal_axes(covariances)  # [T, n], arbitrary per-frame signs
    if len(means) > 1:
        A = transport_matrices(covariances)  # [T-1, n, n]
        # Transporting the tip μ_t + s_t v_t lands at μ_{t+1} + s_t A_t v_t;
        # it is nearer to μ_{t+1} + v_{t+1} than to the negation iff
        # ⟨A_t v_t, v_{t+1}⟩ ≥ 0 (ties keep +, like the reference).
        agree = np.einsum("tij,tj,ti->t", A, v[:-1], v[1:])
        c = np.where(agree >= 0.0, 1.0, -1.0)
        s = np.concatenate([[1.0], np.cumprod(c)])
        v = v * s[:, None]
    # Correlate with the direction of motion; flip globally if negative.
    if len(means) > 1 and np.sum(np.diff(means, axis=0) * v[1:]) < 0:
        v = -v
    return v


def axes_to_yaw_angles(axes: np.ndarray) -> np.ndarray:
    """[T,3] principal axes → [T] yaw angles about +z (atan2 of the xy
    projection; matches calculate_center_rotation.py:184-185 usage)."""
    return np.arctan2(axes[:, 1], axes[:, 0])
