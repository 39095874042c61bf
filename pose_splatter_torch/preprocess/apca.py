"""Adversarial PCA (a copy of ``pose_splatter_tpu/preprocess/apca.py``,
numpy only).

Replacement for the external ``apca`` package used by the reference
(its ``scripts/preprocessing/calculate_visual_embedding.py:7,59-67``:
``AAPCA(n_components, mu, pow_iter, random_state)`` with ``fit_transform(X, Y)``
and ``reconstruct(X, Y)``).

Formulation: find orthonormal components W maximizing retained variance of X
while penalizing the linearly Y-predictable subspace,

    maximize  tr(Wᵀ C_xx W) − μ · tr(Wᵀ C_xy C_yy⁻¹ C_yx W)

i.e. the top-k eigenvectors of  M = C_xx − μ · C_xy C_yy⁻¹ C_yx,
computed by block power iteration (``pow_iter`` rounds) with QR
re-orthonormalization. With μ→0 this reduces to ordinary PCA; large μ
removes the angle-predictable directions (the adversarial target here is
the per-frame yaw (cos θ, sin θ), making the embedding rotation-invariant).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class AAPCA:
    def __init__(self, n_components: int, mu: float = 1e2,
                 pow_iter: int = 20, random_state: Optional[int] = None):
        self.n_components = n_components
        self.mu = mu
        self.pow_iter = pow_iter
        self.random_state = random_state
        self.components_: Optional[np.ndarray] = None  # [d, k]
        self.x_mean_: Optional[np.ndarray] = None
        self.y_mean_: Optional[np.ndarray] = None
        self._y_coef: Optional[np.ndarray] = None  # [k, q] for Y reconstruction

    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, Y: np.ndarray) -> "AAPCA":
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        n, d = X.shape
        q = Y.shape[1]
        self.x_mean_ = X.mean(axis=0)
        self.y_mean_ = Y.mean(axis=0)
        Xc = X - self.x_mean_
        Yc = Y - self.y_mean_

        C_xy = Xc.T @ Yc / n  # [d, q]
        C_yy = Yc.T @ Yc / n + 1e-8 * np.eye(q)
        A = C_xy @ np.linalg.solve(C_yy, C_xy.T)  # [d, d] low-rank (rank q)

        rng = np.random.default_rng(self.random_state)
        W = rng.normal(size=(d, self.n_components))
        W, _ = np.linalg.qr(W)

        def matvec(V):
            # M V = C_xx V − mu A V, with C_xx V = Xᵀ(X V)/n (no d×d matrix).
            return Xc.T @ (Xc @ V) / n - self.mu * (A @ V)

        # Shift to keep the spectrum nonnegative so power iteration converges
        # to the algebraically largest eigenvalues of M.
        shift = self.mu * np.trace(A)
        for _ in range(self.pow_iter):
            W = matvec(W) + shift * W
            W, _ = np.linalg.qr(W)
        self.components_ = W  # [d, k]

        Z = Xc @ W
        self._y_coef, *_ = np.linalg.lstsq(Z, Yc, rcond=None)
        return self

    # ------------------------------------------------------------------
    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, np.float64) - self.x_mean_) @ self.components_

    def fit_transform(self, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
        return self.fit(X, Y).transform(X)

    def reconstruct(self, X: np.ndarray, Y: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (X_rec, Y_rec): X reconstructed from the components and Y
        linearly predicted from them (used to verify the angle information
        was removed — low r² is the goal)."""
        Z = self.transform(X)
        X_rec = Z @ self.components_.T + self.x_mean_
        Y_rec = Z @ self._y_coef + self.y_mean_
        return X_rec, Y_rec
