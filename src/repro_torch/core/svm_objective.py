"""Primal linear-SVM objective, hinge loss and Pegasos sub-gradient.

Port of ``repro.core.svm_objective``. Objective (paper Eq. 1):
f(w) = (λ/2)‖w‖² + (1/N) Σ_j max{0, 1 − y_j⟨w, x_j⟩}.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "hinge_loss",
    "primal_objective",
    "primal_objective_masked",
    "primal_objective_masked_ell",
    "hinge_subgradient",
    "pegasos_update",
    "project_ball",
    "ball_radius",
    "accuracy",
]


def ball_radius(lam: float) -> float:
    """1/√λ formed in float32, as the reference computes it from a Python λ."""
    return float(np.float32(1.0) / np.sqrt(np.float32(lam)))


def hinge_loss(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean hinge loss (1/N) Σ max(0, 1 − y⟨w, x⟩). X: (N, d), y: (N,)."""
    margins = y * (X @ w)
    return torch.clamp(1.0 - margins, min=0.0).mean()


def primal_objective(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """(λ/2)‖w‖² plus the mean hinge loss over all rows."""
    return 0.5 * lam * torch.dot(w, w) + hinge_loss(w, X, y)


def primal_objective_masked(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                            lam: float, valid: torch.Tensor,
                            total: torch.Tensor) -> torch.Tensor:
    """Primal objective over the ``valid`` rows of a padded sample matrix.

    Padded rows carry y=0 and would each add a hinge of 1 to an unmasked
    mean; ``total`` is the true sample count (the sum of the per-node row
    counts).
    """
    margins = y * (X @ w)
    hinge = torch.where(valid, torch.clamp(1.0 - margins, min=0.0),
                        torch.zeros_like(margins)).sum() / total
    return 0.5 * lam * torch.dot(w, w) + hinge


def primal_objective_masked_ell(w: torch.Tensor, cols: torch.Tensor,
                                vals: torch.Tensor, y: torch.Tensor, lam: float,
                                valid: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``primal_objective_masked`` over padded-ELL planes (N, k): the margins
    are a gather-dot against w, dense X is never formed. Pad entries
    (col=0, val=0) are inert; pad rows are left out through ``valid``."""
    margins = y * (vals * w[cols]).sum(dim=-1)
    hinge = torch.where(valid, torch.clamp(1.0 - margins, min=0.0),
                        torch.zeros_like(margins)).sum() / total
    return 0.5 * lam * torch.dot(w, w) + hinge


def hinge_subgradient(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sub-gradient of the mean hinge term: (1/B) Σ_{margin<1} (−y_j x_j), (d,)."""
    margins = y * (X @ w)
    viol = (margins < 1.0).to(X.dtype)
    return -(X.T @ (viol * y)) / X.shape[0]


def pegasos_update(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, lam: float,
                   t: int) -> torch.Tensor:
    """One Pegasos step at iteration t (1-based): α = 1/(λt),
    w ← (1 − λα)w + α·mean_{violators} y·x, then the ball projection. The
    scalars α and 1 − λα are formed in float32, as the reference forms them
    from a float32 t."""
    lam32 = np.float32(lam)
    alpha = np.float32(1.0) / (lam32 * np.float32(t))
    L_hat = -hinge_subgradient(w, X, y)
    w_half = float(np.float32(1.0) - lam32 * alpha) * w + float(alpha) * L_hat
    return project_ball(w_half, lam)


def project_ball(w: torch.Tensor, lam: float) -> torch.Tensor:
    """min{1, (1/√λ)/‖w‖}·w on the last axis: the Pegasos ball projection
    (paper steps f and h). A (m, d) input projects each row."""
    norm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    scale = torch.clamp(ball_radius(lam) / torch.clamp(norm, min=1e-30), max=1.0)
    return w * scale


def accuracy(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of rows whose sign(⟨w, x⟩) equals the label."""
    return (torch.sign(X @ w) == y).to(torch.float32).mean()
